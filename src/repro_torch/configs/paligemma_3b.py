"""PaliGemma 3B [arXiv:2407.07726]: SigLIP vision frontend (STUB — precomputed
patch embeddings) + gemma decoder: 18L, d_model 2048, 8 heads (GQA kv=1,
head_dim 256), d_ff 16384, vocab 257216, 256 image patches."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma_3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend="siglip",
    num_patches=256,
    rope_theta=1e4,
)
