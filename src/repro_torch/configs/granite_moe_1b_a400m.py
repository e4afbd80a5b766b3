"""Granite 3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L, d_model 1024, 16 heads (GQA kv=8), per-expert d_ff 512, 32 experts
top-8, vocab 49155 (padded to 49408 for sharding)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_1b_a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    rope_theta=1e4,
)
