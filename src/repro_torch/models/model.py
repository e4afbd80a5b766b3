"""Models built from a config: parameter init, prefill and decode.

Ported so far: the ``ssm`` family (RWKV-6), whose time mixing runs the
``ssm_scan`` kernel. The other families raise ``NotImplementedError``:
``hybrid`` (Zamba2) comes with the Zamba2 slice, and ``dense``, ``moe``,
``vlm`` and ``audio`` with the attention slices.

Parameters are a dict of tensors with the JAX package's keys; per-layer
weights are stacked on a leading L dim and walked with a Python loop. The
matrices that the JAX package casts to bf16 at every use (the projections,
the low-rank decay's first factor, the embedding and the LM head) are held
in bf16 once, as ``launch/steps.cast_for_compute`` does there: the cast is
deterministic, so the numbers are the same, and decoding does not re-cast
1.7 B parameters a token. Everything else stays fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import COMPUTE_DTYPE, normal_init, rms_norm

__all__ = ["init_params", "params_from_jax", "init_cache", "prefill", "decode_step"]

# held in bf16 (see the module docstring); ``w_lora_b`` is used in fp32
BF16_WEIGHTS = frozenset({
    "embed", "lm_head",
    "w_r", "w_k", "w_v", "w_g", "w_lora_a", "w_o", "w_ck", "w_cv", "w_cr",
})


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "ssm":
        return
    slice_ = "the Zamba2 slice" if cfg.family == "hybrid" else "the attention slices"
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet; it comes with {slice_}"
    )


def _check_ctx(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError("ctx: the port runs on one device; only ctx=None")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _rwkv_params(gen: torch.Generator, cfg: ModelConfig, layers: int, dev: torch.device):
    d, f = cfg.d_model, cfg.d_ff
    lora = 64

    def mat(*s, std=None, dtype=COMPUTE_DTYPE):
        return normal_init(gen, (layers, *s), std, dtype=dtype, device=dev)

    def full(value):
        return torch.full((layers, d), value, dtype=torch.float32, device=dev)

    return {
        "ln1": full(0.0),
        "ln2": full(0.0),
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5), "mu_g": full(0.5),
        "mu_w": full(0.5),
        "w_r": mat(d, d),
        "w_k": mat(d, d),
        "w_v": mat(d, d),
        "w_g": mat(d, d),
        "w0": full(-0.6),
        "w_lora_a": mat(d, lora, std=0.02),
        "w_lora_b": mat(lora, d, std=0.02, dtype=torch.float32),
        "u": full(0.5),
        "ln_w": full(1.0),
        "ln_b": full(0.0),
        "w_o": mat(d, d),
        "mu_ck": full(0.5), "mu_cr": full(0.5),
        "w_ck": mat(d, f),
        "w_cv": mat(f, d),
        "w_cr": mat(d, d),
    }


def init_params(
    cfg: ModelConfig,
    seed_or_generator: Union[int, torch.Generator],
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Random parameters with the JAX package's keys, shapes and scales,
    drawn on ``device`` (``None``: the card, raising without one) from a
    seeded ``torch.Generator``. The draws differ from ``jax.random``'s;
    use :func:`params_from_jax` to compute what the JAX package computes."""
    _check_family(cfg)
    dev = resolve_device(device)
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))
    d, vp = cfg.d_model, cfg.padded_vocab
    return {
        "final_norm": torch.zeros(d, dtype=torch.float32, device=dev),
        "embed": normal_init(gen, (vp, d), 0.02, dtype=COMPUTE_DTYPE, device=dev),
        "lm_head": normal_init(gen, (d, vp), 0.02, dtype=COMPUTE_DTYPE, device=dev),
        "layers": _rwkv_params(gen, cfg, cfg.num_layers, dev),
    }


def params_from_jax(
    tree: Mapping[str, Any], device: Union[None, str, torch.device] = None
) -> Dict[str, Any]:
    """The JAX package's parameter tree, its leaves given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's: same keys, the
    values as tensors on ``device``, :data:`BF16_WEIGHTS` cast to bf16."""
    dev = resolve_device(device)

    def conv(key: str, value: Any):
        if isinstance(value, Mapping):
            return {k: conv(k, v) for k, v in value.items()}
        arr = np.asarray(value)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)  # exact for the fp32 and bf16 leaves
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        return t.to(COMPUTE_DTYPE) if key in BF16_WEIGHTS else t

    return {k: conv(k, v) for k, v in tree.items()}


def _layers(params) -> list:
    stacked = params["layers"]
    depth = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(depth)]


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb[tokens.to(device=emb.device, dtype=torch.long)].to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """Zero cache for ``max_len`` positions (an RWKV-6 cache holds the
    recurrence state and the two token-shift carries, whatever the length).
    ``device="meta"`` sizes it without memory."""
    _check_family(cfg)
    dev = resolve_device(device)
    rw = ssm_mod.rwkv6_init_cache(cfg, batch, COMPUTE_DTYPE, device="meta")
    return {
        k: torch.zeros((cfg.num_layers, *v.shape), dtype=v.dtype, device=dev)
        for k, v in rw.items()
    }


def decode_step(cfg: ModelConfig, params, batch, cache, cur_len, ctx=None):
    """One token for every sequence. ``batch``: {"tokens": (B, 1)}.
    Returns (logits fp32 (B, V), new cache); ``cache`` is not modified."""
    _check_family(cfg)
    _check_ctx(ctx)
    x = _embed(params, batch["tokens"])
    news = []
    for i, p in enumerate(_layers(params)):
        c = {k: v[i] for k, v in cache.items()}
        y, c1 = ssm_mod.rwkv6_decode(rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg, c)
        x = x + y
        z, cm_prev = ssm_mod.rwkv6_channel_mix(
            rms_norm(x, p["ln2"], cfg.norm_eps), p, prev=c["cm_prev"].to(COMPUTE_DTYPE)
        )
        c1["cm_prev"] = cm_prev
        news.append(c1)
        x = x + z
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # the product is rounded to bf16 before the fp32 cast, as in the JAX package
    logits = (x[:, 0] @ params["lm_head"].to(COMPUTE_DTYPE)).float()
    return logits, {k: torch.stack([c[k] for c in news]) for k in cache}


def prefill(cfg: ModelConfig, params, batch, max_len: int, ctx=None):
    """Run the prompt; returns (last-position logits fp32 (B, V), filled
    cache, length)."""
    _check_family(cfg)
    _check_ctx(ctx)
    x = _embed(params, batch["tokens"])
    s = x.shape[1]
    states, tm_prev, cm_prev = [], [], []
    for p in _layers(params):
        a = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, state = ssm_mod.rwkv6_block(a, p, cfg, return_state=True)
        x = x + y
        z, cm = ssm_mod.rwkv6_channel_mix(rms_norm(x, p["ln2"], cfg.norm_eps), p)
        states.append(state)
        tm_prev.append(a[:, -1])
        cm_prev.append(cm)
        x = x + z
    cache = {
        "state": torch.stack(states),
        "tm_prev": torch.stack(tm_prev),
        "cm_prev": torch.stack(cm_prev),
    }
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ params["lm_head"].to(COMPUTE_DTYPE)).float()
    return logits, cache, s
