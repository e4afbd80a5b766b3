"""Zyphra's Zamba2-7B-Instruct, at its published widths and depth
(https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json):
81 Mamba2 layers (hidden 3584, expand 2, 112 heads of 64, state 64, 2
groups, conv 4 with bias), and at the 13 ``hybrid_layer_ids`` one of two
shared transformer blocks, taken in turn, over the concatenation of the
hidden stream and the embedding (7168 wide; 32 heads of 224, RoPE θ 10⁴,
gelu MLP of 14336 with a rank-128 adapter a use), vocab 32000. 7.36 B
parameters with the embedding tied to the LM head (Zamba2's default; the
published config does not say).

:func:`from_hf` reads a config in the published file's keys, so that a
smaller one (the tests', the benchmark's) is built the same way; it raises
on a setting the port does not implement."""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.configs.base import Zamba2Config

__all__ = ["CONFIG", "PUBLISHED", "from_hf"]

# the published config.json's settings that shape the model
PUBLISHED = {
    "adapter_rank": 128, "add_bias_linear": False, "attention_head_dim": 224,
    "attention_hidden_size": 7168, "ffn_hidden_size": 14336, "hidden_act": "gelu",
    "hidden_size": 3584,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    "mamba_d_conv": 4, "mamba_d_state": 64, "mamba_expand": 2, "mamba_headdim": 64,
    "mamba_ngroups": 2, "max_position_embeddings": 4096, "n_mamba_heads": 112,
    "num_attention_heads": 32, "num_hidden_layers": 81, "num_key_value_heads": 32,
    "num_mem_blocks": 2, "rms_norm_eps": 1e-05, "rope_theta": 10000, "use_conv_bias": True,
    "use_mem_rope": True, "use_shared_attention_adapter": False, "use_shared_mlp_adapter": True,
    "vocab_size": 32000,
}

# settings the port implements only one way: (key, the value it takes)
_FIXED = (("add_bias_linear", False), ("hidden_act", "gelu"), ("mamba_d_conv", 4),
          ("use_conv_bias", True), ("use_mem_rope", True),
          ("use_shared_attention_adapter", False), ("use_shared_mlp_adapter", True))


def from_hf(c: Mapping[str, Any], name: str = "zamba2_7b") -> Zamba2Config:
    """The port's config of a Zamba2 given in the published file's keys."""
    for key, value in _FIXED:
        if c.get(key, value) != value:
            raise ValueError(f"{key}={c[key]!r}: the port implements {value!r} only")
    d, heads, hd = int(c["hidden_size"]), int(c["num_attention_heads"]), int(c["attention_head_dim"])
    if int(c.get("attention_hidden_size", 2 * d)) != 2 * d or heads * hd != 2 * d:
        raise ValueError("the shared block attends over the 2 * hidden_size wide concatenation")
    if int(c.get("num_key_value_heads", heads)) != heads:
        raise ValueError("the shared block's attention is multi-head (no grouped kv)")
    cfg = Zamba2Config(
        name=name, family="zamba2", num_layers=int(c["num_hidden_layers"]), d_model=d,
        num_heads=heads, num_kv_heads=heads, head_dim=hd, d_ff=int(c["ffn_hidden_size"]),
        vocab_size=int(c["vocab_size"]), ssm_state=int(c["mamba_d_state"]),
        ssm_head_dim=int(c["mamba_headdim"]), ssm_expand=int(c["mamba_expand"]),
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        hybrid_layer_ids=tuple(int(i) for i in c["hybrid_layer_ids"]),
        num_mem_blocks=int(c["num_mem_blocks"]), adapter_rank=int(c["adapter_rank"]),
        ssm_ngroups=int(c["mamba_ngroups"]))
    if "n_mamba_heads" in c and int(c["n_mamba_heads"]) != cfg.ssm_heads:
        raise ValueError(f"n_mamba_heads {c['n_mamba_heads']} != {cfg.ssm_heads}")
    if cfg.ssm_heads % cfg.ssm_ngroups:
        raise ValueError("mamba_ngroups must divide the Mamba2 heads")
    return cfg


CONFIG = from_hf(PUBLISHED)
