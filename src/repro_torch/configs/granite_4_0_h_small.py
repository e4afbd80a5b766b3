"""IBM's Granite 4.0-H Small, at its published widths and depth
(https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json,
``model_type`` granitemoehybrid): 40 layers of hidden 4096, 36 of them
Mamba2 (expand 2, 128 heads of 64, state 128, 1 group, conv 4 with bias)
and 4 grouped-query attention (32 q heads on 8 kv heads of 128, no
positional encoding, logits scaled by 1/128) at ``layer_types`` 5, 15, 25
and 35; every layer then runs 72 SwiGLU experts of width 768, the top 10 of
each token, beside a shared SwiGLU expert of width 1536. Embedding times
12, each branch times 0.22, logits over 16; vocab 100352, tied embedding.
32.21 B parameters.

:func:`from_hf` reads a config in the published file's keys, so that a
smaller one (the tests', the benchmark's) is built the same way; it raises
on a setting the port does not implement."""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.configs.base import GraniteHybridConfig

__all__ = ["CONFIG", "PUBLISHED", "from_hf"]

_PATTERN = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4

# the published config.json's settings that shape the model
PUBLISHED = {
    "attention_bias": False, "attention_multiplier": 0.0078125, "embedding_multiplier": 12,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 768,
    "layer_types": _PATTERN * 4, "logits_scaling": 16, "mamba_chunk_size": 256,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128,
    "mamba_expand": 2, "mamba_n_groups": 1, "mamba_n_heads": 128, "mamba_proj_bias": False,
    "max_position_embeddings": 131072, "model_type": "granitemoehybrid",
    "normalization_function": "rmsnorm", "num_attention_heads": 32, "num_experts_per_tok": 10,
    "num_hidden_layers": 40, "num_key_value_heads": 8, "num_local_experts": 72,
    "position_embedding_type": "nope", "residual_multiplier": 0.22, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 10000, "shared_intermediate_size": 1536,
    "tie_word_embeddings": True, "vocab_size": 100352,
}

# settings the port implements only one way: (key, the value it takes)
_FIXED = (("attention_bias", False), ("hidden_act", "silu"), ("mamba_conv_bias", True),
          ("mamba_d_conv", 4), ("mamba_proj_bias", False), ("model_type", "granitemoehybrid"),
          ("normalization_function", "rmsnorm"), ("position_embedding_type", "nope"),
          ("tie_word_embeddings", True))


def from_hf(c: Mapping[str, Any], name: str = "granite_4_0_h_small") -> GraniteHybridConfig:
    """The port's config of a Granite 4.0-H given in the published file's keys."""
    for key, value in _FIXED:
        if c.get(key, value) != value:
            raise ValueError(f"{key}={c[key]!r}: the port implements {value!r} only")
    types = tuple(c["layer_types"])
    if len(types) != int(c["num_hidden_layers"]) or set(types) - {"mamba", "attention"}:
        raise ValueError(f"layer_types must name num_hidden_layers mamba or attention layers, "
                         f"got {types!r}")
    experts, k = int(c.get("num_local_experts", 0)), int(c.get("num_experts_per_tok", 0))
    if not 0 < k <= experts:
        raise ValueError(f"the port implements the routed experts only: num_local_experts "
                         f"{experts}, num_experts_per_tok {k}")
    if int(c.get("shared_intermediate_size", 0)) <= 0:
        raise ValueError("the port implements the shared expert only: shared_intermediate_size 0")
    d, heads = int(c["hidden_size"]), int(c["num_attention_heads"])
    if d % heads or heads % int(c["num_key_value_heads"]):
        raise ValueError("hidden_size / num_attention_heads heads, grouped over the kv heads")
    cfg = GraniteHybridConfig(
        name=name, family="granite_hybrid", num_layers=len(types), d_model=d, num_heads=heads,
        num_kv_heads=int(c["num_key_value_heads"]), head_dim=d // heads,
        d_ff=int(c["intermediate_size"]), vocab_size=int(c["vocab_size"]), num_experts=experts,
        experts_per_token=k, ssm_state=int(c["mamba_d_state"]),
        ssm_head_dim=int(c["mamba_d_head"]), ssm_expand=int(c["mamba_expand"]),
        norm_eps=float(c["rms_norm_eps"]), layer_types=types,
        shared_d_ff=int(c["shared_intermediate_size"]), ssm_ngroups=int(c["mamba_n_groups"]),
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        logits_scaling=float(c["logits_scaling"]),
        attention_multiplier=float(c["attention_multiplier"]))
    if "mamba_n_heads" in c and int(c["mamba_n_heads"]) != cfg.ssm_heads:
        raise ValueError(f"mamba_n_heads {c['mamba_n_heads']} != {cfg.ssm_heads}")
    if cfg.ssm_heads % cfg.ssm_ngroups:
        raise ValueError("mamba_n_groups must divide the Mamba2 heads")
    return cfg


CONFIG = from_hf(PUBLISHED)
