"""Granite 3.0 8B base [hf:ibm-granite family]: 40L, d_model 4096, 32 heads
(GQA kv=8), d_ff 12800, vocab 49155 (padded to 49408)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_3_8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=1e4,
)
