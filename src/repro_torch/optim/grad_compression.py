"""Gradient compression for data parallelism: the JAX package's
``repro.optim.grad_compression`` on ``torch.distributed``.

To control the wire format of the gradient reduction across the slow
interconnect, gradients are compressed (bf16, or int8 with one scale for the
tensor shared by the group), all-reduced over the chosen mesh axes, and
decompressed: half (or a quarter) of the fp32 traffic. :func:`compress_decompress`
simulates the wire format on one rank; :func:`compressed_psum` is the
collective, called on local tensors inside :func:`repro_torch.dist.shard_map_compat`
(``local_map``) with a group in the form torch's functional collectives
take, ``(mesh, axis name)``; :func:`make_dp_grad_reducer` averages a tree of
gradients over the data-parallel axes of a mesh with it.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch import tree as tree_mod

__all__ = ["compress_decompress", "compressed_psum", "make_dp_grad_reducer"]


def compress_decompress(g: torch.Tensor, scheme: str = "bf16") -> torch.Tensor:
    """``g`` through the wire format and back, in ``g``'s dtype. int8
    rounds half to even (``torch.round``, as ``jnp.round``)."""
    if scheme == "bf16":
        return g.to(torch.bfloat16).to(g.dtype)
    if scheme == "int8":
        scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.to(g.dtype) * scale
    raise ValueError(scheme)


def compressed_psum(g: torch.Tensor, axis: Any, scheme: str = "bf16") -> torch.Tensor:
    """The sum of ``g`` over the ranks of ``axis`` with a compressed wire
    format, on local tensors (call inside ``local_map``). ``axis``: a
    mesh's dim, ``(mesh, "data")``, or a group as
    ``torch.distributed._functional_collectives`` takes it. bf16 moves
    bf16 on the wire and rounds the sum once (:func:`_bf16_psum`), as
    XLA's bf16 ``psum`` does; int8 takes the group's largest scale
    (``all_reduce`` MAX, as ``pmax``) and sums the quantised values in int32
    (an int8 sum would overflow; the roofline counts the wire as int8)."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.dist.sharding import axis_group

    if isinstance(axis, tuple) and isinstance(axis[1], str):
        axis = axis_group(*axis)
    if scheme == "bf16":
        return _bf16_psum(g, axis)
    if scheme == "int8":
        scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
        scale = funcol.all_reduce(scale, "max", axis)  # one scale for the group
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        s = funcol.all_reduce(q.to(torch.int32), "sum", axis)
        return s.to(g.dtype) * scale
    raise ValueError(scheme)


def _bf16_psum(g: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``g`` in bf16, rounded once: a
    reduce-scatter by ``all_to_all`` (each rank receives every rank's bf16
    values of its segment), the segment summed in fp32 and rounded to bf16,
    then an ``all_gather`` of the segments; about twice the bf16 payload on
    the wire, as a ring all-reduce. A bf16 all-reduce would round every
    partial sum on its way round the ring, hundreds of bf16 ulps off where
    the terms cancel."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.dist.sharding import all_gather, axis_size

    n = axis_size(group)
    flat = g.reshape(-1).to(torch.bfloat16)
    seg = -(-flat.numel() // n)
    flat = torch.nn.functional.pad(flat, (0, seg * n - flat.numel()))
    parts = funcol.all_to_all_single(flat, None, None, group)
    parts = parts.wait() if hasattr(parts, "wait") else parts
    mine = parts.reshape(n, seg).float().sum(0).to(torch.bfloat16)
    full = all_gather(mine, 0, group)
    return full[:g.numel()].reshape(g.shape).to(g.dtype)


def make_dp_grad_reducer(mesh, dp_axes: Tuple[str, ...], scheme: str = "bf16"):
    """Returns ``reduce(grads_tree)``: each leaf averaged over the ranks of
    the ``dp_axes`` of ``mesh`` with the compressed wire format, inside a
    ``local_map`` over the whole mesh with every leaf replicated in and out
    (the JAX package's ``shard_map`` with ``P(None, ...)`` specs). A DTensor
    leaf is gathered first and comes back as a replicated DTensor; a plain
    leaf is this rank's own gradient and comes back plain, the mean of the
    ranks' gradients."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import P, mesh_axes, shard_map_compat

    n = math.prod(mesh_axes(mesh)[a] for a in dp_axes)

    def local(x):
        out = x
        for a in dp_axes:
            out = compressed_psum(out, (mesh, a), scheme)
        return out / n

    def reduce_leaf(g):
        spec = P(*([None] * g.dim()))
        out = shard_map_compat(local, mesh=mesh, in_specs=spec, out_specs=spec)(g)
        return out if isinstance(g, DTensor) else out.to_local()

    return lambda grads: tree_mod.tree_map(reduce_leaf, grads)
