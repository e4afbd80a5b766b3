"""Gemma 3 1B pretrained [hf:google/gemma-3-1b-pt]: 26L, d_model 1152,
4 heads (GQA kv=1, head_dim 256), d_ff 6912, vocab 262144; 5:1
local:global attention (local window 512, every 6th layer global)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    local_window=512,
    global_every=6,
    rope_theta=1e6,
)
