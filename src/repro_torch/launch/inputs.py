"""Meta-tensor stand-ins for every model input, the parameters and the
caches: the JAX package's ``repro.launch.inputs`` (``ShapeDtypeStruct``s
there). They hold shapes and dtypes only, allocate no memory and draw
nothing; the dry-run and the layout rules take them."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import init_cache, init_params

__all__ = ["input_specs", "params_specs", "cache_specs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Model inputs for one step of the given kind (train/prefill/decode)."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        if cfg.family == "audio":
            return {"frame_embeds": _meta((b, s, cfg.d_model), bf16),
                    "labels": _meta((b, s, cfg.num_codebooks), i32)}
        if cfg.family == "vlm":
            st = s - cfg.num_patches
            return {"patch_embeds": _meta((b, cfg.num_patches, cfg.d_model), bf16),
                    "tokens": _meta((b, st), i32), "labels": _meta((b, st), i32)}
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"frame_embeds": _meta((b, s, cfg.d_model), bf16)}
        if cfg.family == "vlm":
            return {"patch_embeds": _meta((b, cfg.num_patches, cfg.d_model), bf16),
                    "tokens": _meta((b, s - cfg.num_patches), i32)}
        return {"tokens": _meta((b, s), i32)}
    # decode: one new token against a seq_len cache
    if cfg.family == "audio":
        return {"frame_embeds": _meta((b, 1, cfg.d_model), bf16)}
    return {"tokens": _meta((b, 1), i32)}


def params_specs(cfg: ModelConfig):
    """The fp32 master parameters, as the JAX package's ``init_params``
    returns them."""
    return init_params(cfg, 0, "meta", masters=True)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
