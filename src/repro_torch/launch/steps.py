"""Step factories: the train, prefill and decode step functions that the
launchers share, as the JAX package's ``repro.launch.steps``.

A train step differentiates :func:`repro_torch.models.forward_train` with
autograd, through :func:`cast_for_compute` down to the fp32 master weights,
and applies AdamW. On one device ``ctx`` is ``None``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward_train, prefill
from repro_torch.optim import OptConfig, adamw_update

__all__ = ["make_train_step", "make_decode_step", "make_prefill_step", "cast_for_compute"]


def cast_for_compute(params, enable: bool = True):
    """Every fp32 leaf of two or more dims in bf16, the rest as it is: the
    JAX package's rule, which casts the stacked per-layer norms and decay
    vectors, the MoE router and RWKV-6's ``w_lora_b`` as well as the
    matrices; the fp32 vectors of one dim (the final norm, Zamba2's shared
    block's norms) stay fp32. The cast is differentiable: gradients reach
    the fp32 leaves."""
    if not enable:
        return params
    return tree_mod.tree_map(
        lambda w: w.to(torch.bfloat16) if (w.dim() >= 2 and w.dtype == torch.float32) else w,
        params,
    )


def make_train_step(cfg: ModelConfig, ctx: Optional[Any], opt_cfg: OptConfig,
                    *, cast_before_gather: bool = True, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` over fp32 master ``params``. ``microbatches`` > 1 splits the
    global batch on its first axis and averages the microbatches' losses and
    gradients, as the reference's ``lax.scan`` does: activation memory is
    that of one microbatch. ``metrics``: ``loss``, ``grad_norm``, ``lr``
    (0-dim tensors on the parameters' device)."""

    def value_and_grad(params, batch):
        req = tree_mod.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = forward_train(cfg, cast_for_compute(req, cast_before_gather), batch, ctx)
        grads = torch.autograd.grad(loss, tree_mod.leaves(req))
        return loss.detach(), tree_mod.unflatten(params, grads)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                  for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=tree_mod.leaves(params)[0].device)
            grads = tree_mod.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(microbatches):
                l, g = value_and_grad(params, {k: v[i] for k, v in mb.items()})
                loss = loss + l / microbatches
                grads = tree_mod.tree_map(lambda a, b: a + b / microbatches, grads, g)
                del g
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_decode_step(cfg: ModelConfig, ctx: Optional[Any], *, cast_before_gather: bool = True):
    """``serve_step(params, cache, batch, cur_len) -> (next tokens, cache)``:
    the greedy token (B, 1), or audio's one a codebook (B, codebooks)."""

    def serve_step(params, cache, batch, cur_len):
        logits, cache = decode_step(
            cfg, cast_for_compute(params, cast_before_gather), batch, cache, cur_len, ctx
        )
        if cfg.family == "audio":
            nxt = torch.argmax(logits.reshape(logits.shape[0], cfg.num_codebooks, -1), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)[:, None]
        return nxt.to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, ctx: Optional[Any], max_len: int,
                      *, cast_before_gather: bool = True):
    """``prefill_step(params, batch) -> (next token (B, 1), cache)``."""

    def prefill_step(params, batch):
        logits, cache, _ = prefill(
            cfg, cast_for_compute(params, cast_before_gather), batch, max_len=max_len, ctx=ctx,
        )
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return prefill_step
