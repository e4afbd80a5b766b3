"""Mesh-aware sharding on ``torch.distributed``: the JAX package's
``repro.dist.sharding``.

JAX runs one program over logical global arrays; the port runs one process
a rank (SPMD over ``torch.distributed``). The counterparts:
  * ``jax.sharding.Mesh`` -> ``torch.distributed.device_mesh.DeviceMesh``
    with named dims;
  * ``PartitionSpec`` -> :class:`P`, the same per-dim entries (``None``, an
    axis name, or a tuple of axis names, major first);
  * ``NamedSharding`` -> :class:`NamedSharding`, whose ``placements`` are
    the DTensor placements of its spec on its mesh (:func:`placements`);
  * ``with_sharding_constraint`` -> ``DTensor.redistribute``;
  * ``shard_map`` -> ``local_map`` (:func:`shard_map_compat`).

One :class:`ParallelCtx` describes how a step runs on a mesh: which axes
carry data parallelism (``dp``: 'pod' and 'data' where present) and which
axis carries model parallelism (``model``). ``ctx=None`` everywhere means
one device: every helper here is then a no-op, or a fully replicated
layout. Every rule is divisibility-guarded, so an awkward shape falls back
to replication on that dim.

Layout rules, as in the JAX package:
  * params at rest: FSDP, the largest divisible dim of every rank-≥2 leaf
    over 'data'; rank-<2 leaves (norms, biases) are replicated;
  * activations: batch over ``dp``; attention heads over 'model'
    (:func:`constrain_qkv`); the hidden dim unsharded (:func:`constrain_hidden`);
  * KV caches: batch dim over ``dp``, kv-head dim over 'model'.

The rules are functions of the mesh's axis names and sizes only: they take
a ``DeviceMesh`` or an :class:`AbstractMesh` (names and sizes, no process
group), so specs can be computed and compared without any rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_mod

__all__ = [
    "AbstractMesh",
    "P",
    "NamedSharding",
    "ParallelCtx",
    "make_ctx",
    "mesh_axes",
    "axis_group",
    "axis_size",
    "all_gather",
    "batch_spec",
    "qkv_spec",
    "placements",
    "distribute",
    "param_shardings",
    "input_shardings",
    "cache_shardings",
    "constrain_qkv",
    "constrain_hidden",
    "shard_map_compat",
    "as_dtensor",
    "replicate_plain",
    "on_mesh",
]


class P(tuple):
    """A partition spec: one entry a tensor dim, ``None`` (replicated), an
    axis name, or a tuple of axis names (sharded over their product, the
    first the major one), as ``jax.sharding.PartitionSpec``, which also
    takes a tuple of one name as that name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without ranks, as
    ``jax.sharding.AbstractMesh``: enough for every layout rule."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    if not mesh.mesh_dim_names:
        raise ValueError("the mesh's dims need names (mesh_dim_names)")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_group(mesh, axis: str) -> tuple:
    """The group of ``mesh``'s dim ``axis`` as torch's functional
    collectives take it: ``(mesh, dim index)``."""
    return (mesh, list(mesh_axes(mesh)).index(axis))


def axis_size(group) -> int:
    """The number of ranks in a group given as ``(mesh, dim index)``."""
    mesh, dim = group
    return mesh.size(dim)


def all_gather(t: torch.Tensor, dim: int, group, *, autograd: bool = False) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` over ``group`` (a functional
    collective; ``autograd``: its backward is the reduce-scatter), in the
    name this torch has (``all_gather_single``, earlier ``all_gather_tensor``)."""
    from torch.distributed import _functional_collectives as funcol

    if autograd:
        fn = getattr(funcol, "all_gather_single_autograd", None) or funcol.all_gather_tensor_autograd
    else:
        fn = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    out = fn(t, dim, group)
    return out.wait() if hasattr(out, "wait") else out


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements (one a mesh dim) of ``spec`` on ``mesh``: a
    mesh dim named in the entry of tensor dim ``d`` shards it
    (``Shard(d)``), every other mesh dim replicates. An entry naming two
    axes shards its dim over both, the first axis the major one, which is
    DTensor's order when the axes are in the mesh's order. A mesh dim of
    size 1 replicates: its one shard is the whole, and DTensor's view rules
    refuse to fold a dim of size 1 that is marked sharded."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,) if entry is not None else ()
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"{spec}: the axes of dim {d} must follow the mesh's order {names}")
        for a in axes:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def distribute(x, sharding: NamedSharding, *, src_data_rank: Optional[int] = 0):
    """``x`` laid out by ``sharding``: a DTensor on its mesh. A plain
    tensor is the global value (rank ``src_data_rank``'s, or each rank's
    own copy with ``None``); a DTensor on the same mesh is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=src_data_rank)


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """How one step is parallelised over a mesh."""

    mesh: Any  # a DeviceMesh, an AbstractMesh, or None
    mode: str = "train"  # "train" (SP/FSDP layouts) | "serve" (TP layouts)
    dp: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    analysis: bool = False  # stub the SSM scan so the dry-run's counts add its closed form


def make_ctx(mesh, *, mode: str = "train") -> ParallelCtx:
    if mesh is None:
        return ParallelCtx(mesh=None, mode=mode)
    names = tuple(mesh_axes(mesh))
    dp = tuple(a for a in ("pod", "data") if a in names)
    model_axis = "model" if "model" in names else None
    return ParallelCtx(mesh=mesh, mode=mode, dp=dp, model_axis=model_axis)


def on_mesh(ctx: Optional[ParallelCtx]) -> bool:
    return ctx is not None and ctx.mesh is not None


def _axis_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in (axes if isinstance(axes, (tuple, list)) else (axes,)))


def _dp_if_divisible(ctx: ParallelCtx, dim: int):
    if ctx.dp and dim % _axis_size(ctx.mesh, ctx.dp) == 0:
        return ctx.dp
    return None


def _model_if_divisible(ctx: ParallelCtx, dim: int):
    if ctx.model_axis and dim % _axis_size(ctx.mesh, ctx.model_axis) == 0:
        return ctx.model_axis
    return None


# ---------------------------------------------------------------------------
# At-rest layouts
# ---------------------------------------------------------------------------


def param_shardings(tree: Any, ctx: Optional[ParallelCtx]) -> Any:
    """FSDP at-rest layout: shard the largest divisible dim of each rank-≥2
    leaf over 'data'. Takes tensors (meta ones too); returns a matching tree
    of :class:`NamedSharding` (or None off-mesh)."""
    if not on_mesh(ctx):
        return None
    mesh = ctx.mesh
    sizes = mesh_axes(mesh)
    data = "data" if "data" in sizes else None

    def leaf_sharding(x) -> NamedSharding:
        shape = tuple(x.shape)
        if data is None or len(shape) < 2:
            return NamedSharding(mesh, P())
        size = sizes[data]
        divisible = [d for d in range(len(shape)) if shape[d] % size == 0 and shape[d] > 0]
        if not divisible:
            return NamedSharding(mesh, P())
        d = max(divisible, key=lambda i: shape[i])
        spec = [None] * len(shape)
        spec[d] = data
        return NamedSharding(mesh, P(*spec))

    return tree_mod.tree_map(leaf_sharding, tree)


def input_shardings(cfg, shape, ctx: Optional[ParallelCtx]) -> Dict[str, P]:
    """Batch-over-dp specs for every input of this step shape."""
    from repro_torch.launch.inputs import input_specs

    specs = input_specs(cfg, shape)
    if not on_mesh(ctx):
        return {k: P() for k in specs}
    return {name: batch_spec(ctx, t.shape) for name, t in specs.items()}


def batch_spec(ctx: ParallelCtx, shape) -> P:
    """The batch dim (the first) over ``dp`` where it divides, the rest
    replicated."""
    return P(*([_dp_if_divisible(ctx, shape[0])] + [None] * (len(shape) - 1)))


def cache_shardings(cfg, shape, ctx: Optional[ParallelCtx]) -> Callable[[Any], Any]:
    """Returns a tree mapper: KV-cache leaves get batch-over-dp and
    kv-heads-over-model (the leading layer dim replicated)."""

    def mapper(tree: Any) -> Any:
        if not on_mesh(ctx):
            return tree_mod.tree_map(lambda x: None, tree)
        kv = getattr(cfg, "num_kv_heads", 0)

        def leaf_sharding(x) -> NamedSharding:
            spec = [None] * len(x.shape)
            for d, n in enumerate(x.shape):
                if d > 0 and n == shape.global_batch and spec[d] is None:
                    spec[d] = _dp_if_divisible(ctx, n)
                    break
            for d in range(len(x.shape) - 1, 0, -1):
                if x.shape[d] == kv and spec[d] is None:
                    spec[d] = _model_if_divisible(ctx, x.shape[d])
                    break
            return NamedSharding(ctx.mesh, P(*spec))

        return tree_mod.tree_map(leaf_sharding, tree)

    return mapper


# ---------------------------------------------------------------------------
# In-flight constraints
# ---------------------------------------------------------------------------


def as_dtensor(x, mesh):
    """A plain tensor enters a mesh as replicated: every rank holds the
    same value (what the model makes itself: positions, masks, caches)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * len(mesh_axes(mesh)), run_check=False)


def _constrain(x, ctx: ParallelCtx, spec: P):
    return as_dtensor(x, ctx.mesh).redistribute(ctx.mesh, placements(spec, ctx.mesh))


def qkv_spec(ctx: ParallelCtx, shape) -> P:
    """(b, s, h, hd): batch over dp, heads over 'model', where they divide."""
    b, _, h, _ = shape
    return P(_dp_if_divisible(ctx, b), None, _model_if_divisible(ctx, h), None)


def constrain_qkv(q, k, v, ctx: Optional[ParallelCtx]):
    """Shard attention heads over 'model' and batch over dp: (b, s, h, hd)."""
    if not on_mesh(ctx):
        return q, k, v
    return tuple(_constrain(t, ctx, qkv_spec(ctx, t.shape)) for t in (q, k, v))


def constrain_hidden(x, cfg, ctx: Optional[ParallelCtx]):
    """Batch over dp for the (b, s, d) hidden stream; the hidden dim stays
    unsharded (the products gather what they contract:
    ``models.layers.local_operands``)."""
    if not on_mesh(ctx):
        return x
    return _constrain(x, ctx, P(_dp_if_divisible(ctx, x.shape[0]), None, None))


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def shard_map_compat(f, *, mesh, in_specs, out_specs):
    """``jax.shard_map``'s counterpart over ``local_map``: ``f`` runs on each
    rank's local shards of its tensor arguments, laid out by ``in_specs``
    (one :class:`P` an argument, or one P for a single argument; DTensors
    are redistributed, plain tensors enter as replicated), and its outputs
    become DTensors laid out by ``out_specs`` (a P, or a tuple of them).
    ``f`` reaches the other ranks through functional collectives over the
    mesh's groups (``(mesh, axis)``).

    Gradients follow shard_map's transpose: an output's gradient is divided
    by the size of the mesh axes its spec leaves out (the ranks along them
    hold the same output), and an argument's gradient is summed over the
    axes its spec leaves out (``Partial``)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    sizes = list(mesh_axes(mesh).values())
    in_specs = (in_specs,) if isinstance(in_specs, P) else tuple(in_specs)
    in_pl = tuple(placements(s, mesh) for s in in_specs)
    grad_pl = tuple(tuple(p if isinstance(p, Shard) else Partial() for p in pl) for pl in in_pl)
    single_out = isinstance(out_specs, P)
    outs = (out_specs,) if single_out else tuple(out_specs)
    out_pl = [list(placements(s, mesh)) for s in outs]
    scales = [1.0 / math.prod(n for n, p in zip(sizes, pl) if not isinstance(p, Shard))
              for pl in out_pl]

    def local(*args):
        res = f(*args)
        res = [res] if single_out else list(res)
        res = [_ScaleGrad.apply(r, sc) if sc != 1.0 and r.requires_grad else r
               for r, sc in zip(res, scales)]
        return res[0] if single_out else tuple(res)

    mapped = local_map(local, out_placements=out_pl[0] if single_out else tuple(out_pl),
                       in_placements=in_pl, in_grad_placements=grad_pl, device_mesh=mesh,
                       redistribute_inputs=True)

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} in_specs")
        return mapped(*(as_dtensor(a, mesh) if hasattr(a, "shape") else a for a in args))

    return call


def replicate_plain(ctx: Optional[ParallelCtx]):
    """Off-mesh a no-op. On a mesh, torch's ``implicit_replication()``:
    DTensor ops take the plain tensors that the model makes itself
    (positions, masks, caches, RoPE tables) as replicated. It does not nest
    (its exit clears the flag), so each layer enters it once and not
    around another's: the model's entry points around the forward, the
    train step around the backward (autograd's replay of the forward) and
    around the optimizer update."""
    if not on_mesh(ctx):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()
