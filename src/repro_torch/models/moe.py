"""Mixture-of-Experts FFN with capacity-based gather dispatch.

The JAX package's ``moe_ffn_local`` and ``moe_ffn``, op for op: fp32 router
logits, softmax, the top ``k`` experts with their gates renormalised, each
(token, choice) pair's position within its expert by a one-hot cumsum in
the flattened (T, k) order, dropless up to ``t*k <= dropless_threshold``
and otherwise a capacity of ``max(1, int(t*k/e*capacity_factor))`` slots an
expert, with the pairs over capacity sent to a sink row that is discarded.
The experts' SwiGLU runs as batched bf16 products over the (E, cap, D)
slots, and the kept slots are gathered back, scaled by their gates in bf16
and summed over the k choices.

The JAX package computes all of this outside any kernel, and so does the
port, on either device. Under a mesh (``ctx``) the dispatch stays local to
each rank's tokens through ``local_map`` (the JAX package's ``shard_map``):
in the training (SP) layout the tokens are split by batch over the
data-parallel axes and by sequence over 'model', and the expert weights
enter at their at-rest FSDP layout and are all-gathered inside in bf16
over 'data' then 'model' (the gathers' backward is a bf16 reduce-scatter);
in the serving (TP) layout the experts' FFN dims are split over 'model' and
the partial outputs are summed over it (``tp_axis``).

Beside it, for the port's own IBM Granite 4.0-H (``models/granite_hybrid.py``):
:func:`moe_ffn_dropless`, the same router and experts with no capacity
(every pair kept: the pairs stably sorted by expert, one SwiGLU a
contiguous segment, read back in the (T, k) order and combined as above),
and :func:`moe_ffn_shared`, the routed experts plus a shared SwiGLU expert
that every token takes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.dist.sharding import (P, all_gather, axis_group, mesh_axes, on_mesh,
                                       shard_map_compat)
from repro_torch.models.layers import COMPUTE_DTYPE, dense_ffn, matmul, swiglu

__all__ = ["moe_ffn", "moe_ffn_dropless", "moe_ffn_local", "moe_ffn_shared", "route"]

# tokens a dropless dispatch gathers at once: its (token, expert) rows and
# their outputs are two buffers of tokens × k × D bf16 (1.3 GB each at
# 16384 tokens, k 10, D 4096)
DISPATCH_TOKENS = 16384


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
    tp_axis: Optional[Any] = None,
    dropless_threshold: int = 4096,
) -> torch.Tensor:
    """``tp_axis``: the group (``(mesh, dim)``, as torch's functional
    collectives take it) whose ranks hold parts of the experts' FFN dim;
    their partial outputs are summed over it."""
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
    if tp_axis is not None:  # combine the tensor-parallel partials
        from torch.distributed import _functional_collectives as funcol

        ye = funcol.all_reduce(ye, "sum", tp_axis)
    ye = torch.cat([ye, torch.zeros((1, d), dtype=dt, device=x.device)], 0)
    out = ye[slot] * (gval.reshape(-1)[:, None] * keep[:, None]).to(dt)
    return out.reshape(t, k, d).sum(1)


def moe_ffn_dropless(
    x: torch.Tensor,  # (T, D) tokens
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    k: int,
) -> torch.Tensor:
    """:func:`moe_ffn_local`'s router, experts and combination with every
    (token, choice) pair kept, whatever the load. The pairs of each
    :data:`DISPATCH_TOKENS` tokens are stably sorted by expert, each
    expert's SwiGLU runs once over its contiguous segment, and the outputs
    go back to the (T, k) order, scaled by their gates in bf16 and summed over the k
    choices. The segments' sizes are read on the host once a call, for
    every chunk at once (one sync). A span ``moe.dispatch`` (layer ``moe``)
    counts the ``pairs`` that went through an expert's product (T · k when
    none is dropped), the ``experts_hit``, the largest load an expert takes
    (``max_load``) and the host ``syncs``."""
    t, d = x.shape
    e = router_w.shape[1]
    dt = COMPUTE_DTYPE
    chunk = DISPATCH_TOKENS
    with trace.span("moe.dispatch", "moe") as sp:
        gval, gidx = route(x, router_w, k)
        chunks = -(-t // chunk)
        owner = (torch.arange(t, device=x.device) // chunk)[:, None] * e + gidx
        loads = torch.bincount(owner.reshape(-1), minlength=chunks * e).view(chunks, e)
        per_expert = loads.sum(0)
        host = torch.cat([loads.reshape(-1), per_expert]).tolist()  # the one sync
        loads, per_expert = [host[c * e:(c + 1) * e] for c in range(chunks)], host[chunks * e:]
        sp.count(experts_hit=sum(n > 0 for n in per_expert), max_load=max(per_expert), syncs=1)
        out = torch.empty((t, d), dtype=dt, device=x.device)
        pairs = 0
        for c in range(chunks):
            lo, hi = c * chunk, min(t, (c + 1) * chunk)
            order = torch.argsort(gidx[lo:hi].reshape(-1), stable=True)
            xs = x[lo + order // k].to(dt)  # (pairs, D), by expert
            ys = torch.empty_like(xs)
            start = 0
            for ex, n in enumerate(loads[c]):
                if n:
                    seg = xs[start:start + n]
                    h = swiglu(matmul(seg, w_gate[ex]), matmul(seg, w_up[ex]))
                    ys[start:start + n] = matmul(h, w_down[ex])
                    start += n
            pairs += start
            del xs
            ys *= gval[lo:hi].reshape(-1)[order, None].to(dt)
            back = torch.empty_like(ys)
            back[order] = ys
            del ys
            out[lo:hi] = back.view(hi - lo, k, d).sum(1)
        sp.count(pairs=pairs)
    return out


def moe_ffn_shared(x: torch.Tensor, params: Dict[str, torch.Tensor], *, k: int,
                   dropless: bool) -> torch.Tensor:
    """The routed experts and, beside them, the shared SwiGLU expert that
    every token takes, summed: x (T, D) -> (T, D). ``params``: ``router``
    (D, E), ``w_gate``, ``w_up`` (E, D, F), ``w_down`` (E, F, D),
    ``shared_gate``, ``shared_up`` (D, Fs) and ``shared_down`` (Fs, D).
    ``dropless``: :func:`moe_ffn_dropless` (a prefill); else
    :func:`moe_ffn_local` with a capacity of every token, whose shapes do
    not depend on the routing, so that a decode step can be captured (every
    expert's product runs over T slots)."""
    args = (x, params["router"], params["w_gate"], params["w_up"], params["w_down"])
    if dropless:
        routed = moe_ffn_dropless(*args, k=k)
    else:
        routed = moe_ffn_local(*args, k=k, dropless_threshold=x.shape[0] * k)
    return routed + dense_ffn(x, params["shared_gate"], params["shared_up"],
                              params["shared_down"])


def moe_ffn(
    x: torch.Tensor,  # (B, S, D)
    params: Dict[str, torch.Tensor],
    *,
    k: int,
    capacity_factor: float = 1.25,
    ctx: Optional[Any] = None,  # ParallelCtx (repro_torch.dist) or None
) -> torch.Tensor:
    """The MoE FFN over a batch: :func:`moe_ffn_local` over its B*S tokens,
    or over each rank's tokens on a mesh (the layout follows ``ctx.mode``:
    'train' SP, 'serve' TP). ``params``: ``router`` (D, E), ``w_gate``,
    ``w_up`` (E, D, F) and ``w_down`` (E, F, D)."""
    b, s, d = x.shape
    rw, wg, wu, wd = params["router"], params["w_gate"], params["w_up"], params["w_down"]
    if not on_mesh(ctx):
        y = moe_ffn_local(x.reshape(b * s, d), rw, wg, wu, wd, k=k,
                          capacity_factor=capacity_factor)
        return y.reshape(b, s, d)

    mesh = ctx.mesh
    sizes = mesh_axes(mesh)
    dp, ma = tuple(ctx.dp), ctx.model_axis
    bspec = dp if dp and b % math.prod(sizes[a] for a in dp) == 0 else None  # batch-1 decode
    fsdp_ax = "data" if "data" in sizes else None
    if ctx.mode == "train":
        xspec = P(bspec, ma, None)  # SP layout: batch over dp, sequence over model
        # the experts enter at their at-rest FSDP layout and are gathered
        # inside in bf16; the gathers' backward is a bf16 reduce-scatter
        wspec = (P(), P(None, fsdp_ax, ma), P(None, fsdp_ax, ma), P(None, fsdp_ax, ma))
        tp_axis = None
        gather = [(a, dim) for a, dim in ((fsdp_ax, 1), (ma, 2)) if a]
    else:
        xspec = P(bspec, None, None)  # serve layout: the experts' FFN dim over model
        wspec = (P(), P(None, None, ma), P(None, None, ma), P(None, ma, None))
        tp_axis = axis_group(mesh, ma) if ma else None
        gather = []

    def gather_w(w):
        for a, dim in gather:  # (E, D|F, F|D): dim 1 over 'data', dim 2 over 'model'
            w = all_gather(w, dim, axis_group(mesh, a), autograd=True)
        return w

    def local(xl, rwl, wgl, wul, wdl):
        bl, sl, _ = xl.shape
        y = moe_ffn_local(xl.reshape(bl * sl, d), rwl, gather_w(wgl), gather_w(wul),
                          gather_w(wdl), k=k, capacity_factor=capacity_factor, tp_axis=tp_axis)
        return y.reshape(bl, sl, d)

    y = shard_map_compat(local, mesh=mesh, in_specs=(xspec,) + wspec,
                         out_specs=xspec)(x, rw, wg, wu, wd)
    # back in the hidden stream's layout: the train layout's sequence split
    # would leave the stream's (B, S) flatten a dim it cannot fold locally
    return y.redistribute(x.device_mesh, x.placements) if hasattr(x, "placements") else y
