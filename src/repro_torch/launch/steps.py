"""Step factories: the train, prefill and decode step functions that the
launchers share, as the JAX package's ``repro.launch.steps``.

A train step differentiates :func:`repro_torch.models.forward_train` with
autograd, through :func:`cast_for_compute` down to the fp32 master weights,
and applies AdamW. On one device ``ctx`` is ``None``. On a mesh
(:func:`repro_torch.dist.make_ctx`) the parameters are DTensors laid out
by ``param_shardings`` (the optimizer state follows them); the steps take
plain global batches, the same on every rank, and place them batch over the
data-parallel axes. A gradient comes back in its parameter's layout (the
FSDP reduce-scatter), and the metrics are plain scalars on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (NamedSharding, batch_spec, cache_shardings, distribute,
                                       on_mesh, replicate_plain)
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
        batch = place_batch(batch, ctx)
        req = tree_mod.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = forward_train(cfg, cast_for_compute(req, cast_before_gather), batch, ctx)
        with replicate_plain(ctx):  # autograd replays the forward's ops
            grads = torch.autograd.grad(loss, tree_mod.leaves(req))
            if on_mesh(ctx):  # each gradient in its parameter's layout
                grads = [g.redistribute(p.device_mesh, p.placements) for g, p in
                         zip(grads, tree_mod.leaves(params))]
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
        with replicate_plain(ctx):
            params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics = {k: _plain(v) for k, v in metrics.items()}
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_decode_step(cfg: ModelConfig, ctx: Optional[Any], *, cast_before_gather: bool = True):
    """``serve_step(params, cache, batch, cur_len) -> (next tokens, cache)``:
    the greedy token (B, 1), or audio's one a codebook (B, codebooks). On a
    mesh the tokens are plain, the cache keeps its layout."""

    def serve_step(params, cache, batch, cur_len):
        logits, cache = decode_step(
            cfg, cast_for_compute(params, cast_before_gather), place_batch(batch, ctx), cache,
            cur_len, ctx
        )
        logits = _plain(logits)
        if cfg.family == "audio":
            nxt = torch.argmax(logits.reshape(logits.shape[0], cfg.num_codebooks, -1), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)[:, None]
        return nxt.to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, ctx: Optional[Any], max_len: int,
                      *, cast_before_gather: bool = True):
    """``prefill_step(params, batch) -> (next token (B, 1), cache)``. On a
    mesh the token is plain and the cache is laid out by
    ``cache_shardings`` (batch over dp, kv heads over 'model')."""

    def prefill_step(params, batch):
        batch = place_batch(batch, ctx)
        logits, cache, _ = prefill(
            cfg, cast_for_compute(params, cast_before_gather), batch, max_len=max_len, ctx=ctx,
        )
        if on_mesh(ctx):
            b = tree_mod.leaves(batch)[0].shape[0]
            shardings = cache_shardings(cfg, ShapeConfig("prefill", max_len, b, "prefill"),
                                        ctx)(cache)
            cache = tree_mod.tree_map(distribute, cache, shardings)
        return torch.argmax(_plain(logits), dim=-1).to(torch.int32)[:, None], cache

    return prefill_step


def place_batch(batch: Dict[str, torch.Tensor], ctx) -> Dict[str, torch.Tensor]:
    """Off-mesh the batch as it is; on a mesh each plain input (the global
    batch, the same on every rank) as a DTensor, batch over dp."""
    if not on_mesh(ctx):
        return batch
    return {k: distribute(v, NamedSharding(ctx.mesh, batch_spec(ctx, v.shape)),
                          src_data_rank=None) for k, v in batch.items()}


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value, a plain tensor on every rank (a collective
    that every rank calls); a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t
