"""MusicGen medium [arXiv:2306.05284]: decoder-only over EnCodec tokens
(frontend STUB — precomputed frame embeddings), 48L, d_model 1536, 24 heads
(MHA kv=24, head_dim 64), d_ff 6144, 4 codebooks × vocab 2048."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="encodec",
    num_codebooks=4,
    rope_theta=1e4,
)
