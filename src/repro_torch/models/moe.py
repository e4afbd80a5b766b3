"""Mixture-of-Experts FFN with capacity-based gather dispatch, on one device.

The JAX package's ``moe_ffn_local`` and the ``ctx=None`` branch of its
``moe_ffn``, op for op: fp32 router logits, softmax, the top ``k`` experts
with their gates renormalised, each (token, choice) pair's position within
its expert by a one-hot cumsum in the flattened (T, k) order, dropless up to
``t*k <= dropless_threshold`` and otherwise a capacity of
``max(1, int(t*k/e*capacity_factor))`` slots an expert, with the pairs over
capacity sent to a sink row that is discarded. The experts' SwiGLU runs as
batched bf16 products over the (E, cap, D) slots, and the kept slots are
gathered back, scaled by their gates in bf16 and summed over the k choices.

The JAX package computes all of this outside any kernel, and so does the
port, on either device. Under a mesh the JAX package shard_maps the
dispatch; the port runs on one device and raises on a ``ctx``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, matmul, swiglu

__all__ = ["moe_ffn", "moe_ffn_local", "route"]


def route(x: torch.Tensor, router_w: torch.Tensor, k: int):
    """The router: fp32 logits and softmax, then the top ``k`` gates of each
    token in descending order, ties to the lower expert (as
    ``jax.lax.top_k``: a stable sort), renormalised to sum to 1. Returns
    (gates (T, k) fp32, experts (T, k) int64)."""
    gates = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gval, gidx = torch.sort(gates, dim=-1, descending=True, stable=True)
    gval, gidx = gval[:, :k], gidx[:, :k]
    return gval / torch.clamp_min(gval.sum(-1, keepdim=True), 1e-9), gidx


def capacity(t: int, k: int, e: int, capacity_factor: float,
             dropless_threshold: int = 4096) -> int:
    """Slots an expert: every token when ``t*k`` is at most the threshold
    (decode, small prefills), else the capacity-bounded count."""
    if t * k <= dropless_threshold:
        return t
    return max(1, int(t * k / e * capacity_factor))


def slots(gidx: torch.Tensor, e: int, cap: int):
    """Each (token, choice) pair's row in the (E*cap + 1, D) dispatch
    buffer, in the flattened (T, k) order: ``expert*cap + position`` where
    the position (earlier pairs routed to the same expert) is under ``cap``,
    the sink row ``e*cap`` otherwise. Returns (slot (T*k,), keep (T*k,))."""
    eflat = gidx.reshape(-1)
    onehot = F.one_hot(eflat, e).to(torch.int32)
    pos = (torch.cumsum(onehot, 0) - 1).gather(1, eflat[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, eflat * cap + pos, torch.full_like(eflat, e * cap))
    return slot, keep


def moe_ffn_local(
    x: torch.Tensor,  # (T, D) tokens
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    k: int,
    capacity_factor: float = 1.25,
    dropless_threshold: int = 4096,
) -> torch.Tensor:
    t, d = x.shape
    e = router_w.shape[1]
    dt = COMPUTE_DTYPE
    gval, gidx = route(x, router_w, k)
    cap = capacity(t, k, e, capacity_factor, dropless_threshold)
    slot, keep = slots(gidx, e, cap)
    tok = torch.arange(t * k, device=x.device) // k
    # the sink row takes every dropped pair's write; it is never read
    xe = torch.zeros((e * cap + 1, d), dtype=dt, device=x.device)
    xe[slot] = x[tok].to(dt)
    xe = xe[: e * cap].reshape(e, cap, d)
    h = swiglu(matmul(xe, w_gate), matmul(xe, w_up))
    ye = matmul(h, w_down).reshape(e * cap, d)
    ye = torch.cat([ye, torch.zeros((1, d), dtype=dt, device=x.device)], 0)
    out = ye[slot] * (gval.reshape(-1)[:, None] * keep[:, None]).to(dt)
    return out.reshape(t, k, d).sum(1)


def moe_ffn(
    x: torch.Tensor,  # (B, S, D)
    params: Dict[str, torch.Tensor],
    *,
    k: int,
    capacity_factor: float = 1.25,
    ctx: Optional[Any] = None,
) -> torch.Tensor:
    """The MoE FFN over a batch: :func:`moe_ffn_local` over its B*S tokens.
    ``params``: ``router`` (D, E), ``w_gate``, ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D)."""
    if ctx is not None:
        raise NotImplementedError("ctx: the port runs on one device; only ctx=None")
    b, s, d = x.shape
    y = moe_ffn_local(
        x.reshape(b * s, d), params["router"], params["w_gate"], params["w_up"],
        params["w_down"], k=k, capacity_factor=capacity_factor,
    )
    return y.reshape(b, s, d)
