"""Mixtral 8x7B [arXiv:2401.04088]: 32L, d_model 4096, 32 heads (GQA kv=8),
d_ff 14336 per expert, 8 experts top-2, sliding-window attention, vocab 32000."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    window=4096,
    rope_theta=1e6,
)
