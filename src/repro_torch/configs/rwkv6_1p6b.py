"""RWKV-6 (Finch) 1.6B [arXiv:2404.05892]: attention-free, 24L, d_model 2048
(32 state heads of 64), channel-mix d_ff 7168, vocab 65536, data-dependent
per-channel decay."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1p6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    rwkv=True,
    ssm_head_dim=64,
    ssm_state=64,
)
