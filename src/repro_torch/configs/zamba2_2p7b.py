"""The JAX package's Zamba2 stand-in, named after Zamba2 2.7B
[arXiv:2411.15242] but not Zyphra's layout: 54 Mamba2 layers (d_model 2560,
ssm_state 64, one SSM group, a conv over x alone and without bias) and ONE
shared attention+SwiGLU block (32 heads MHA, head_dim 80, over ``d_model``,
d_ff 10240, no adapters) applied on the residual stream after every 6th
layer, vocab 32000. Kept equal to the JAX package's config, which the CPU
tests hold it to. Zyphra's published layout (two alternating shared blocks
over the concatenated embedding, per-use adapters, grouped Mamba2) is
``zamba2_7b``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_2p7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    rope_theta=1e4,
)
