"""Phi-3 medium 14B [arXiv:2404.14219]: 40L, d_model 5120, 40 heads
(GQA kv=10), d_ff 17920, vocab 100352, RoPE + SwiGLU."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3_medium_14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=1e4,
)
