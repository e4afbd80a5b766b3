"""Roofline terms of one step on a mesh, from the port's dry-run
(``launch/dryrun.py``): the JAX package's ``repro.launch.hlo_analysis``,
keeping its name so the counterpart is easy to find.

JAX reads FLOPs and bytes from XLA's ``cost_analysis()`` and collectives
from the post-SPMD HLO text. The port has no HLO: the dry-run counts FLOPs
with ``torch.utils.flop_counter`` and records each functional collective
that a rank issues (:class:`StepTrace`: its kind and result bytes),
and :func:`collective_bytes` sums them with the same multiplier per kind
(a ring all-reduce moves about twice its payload; all-gather,
reduce-scatter, all-to-all and permute about once).
:func:`roofline_terms`, :func:`ssm_scan_costs` and :func:`model_flops` are
the JAX package's, verbatim.

Hardware model (:data:`HW`): one NVIDIA H100 SXM, the data sheet's dense
peaks (the same figures as ``chip_smoke.py``): 989.4 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s HBM, and NVLink at 450 GB/s a direction. These are
published peaks at the 700 W limit, not measurements.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HW", "StepTrace", "collective_bytes", "roofline_terms", "model_flops",
           "ssm_scan_costs"]

HW = {
    "name": "NVIDIA H100 SXM (data sheet, 700 W)",
    "peak_flops": 989.4e12,  # bf16 per card, dense
    "hbm_bw": 3.35e12,  # bytes/s per card
    "ici_bw": 450e9,  # NVLink bytes/s a direction per card
}

_MULTIPLIER = {
    "all-reduce": 2.0,  # ring: reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# the c10d functional ops' names -> the kinds above
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


class StepTrace(TorchDispatchMode):
    """What one rank does in a step, seen at the level of its local tensors:
    under the mode, an op on DTensors is left to DTensor (``NotImplemented``,
    as ``CommDebugMode`` does; so are the fake-tensor runs of its sharding
    propagation), so the mode sees the local ops and the
    functional collectives (``torch.ops._c10d_functional``) that DTensor's
    redistributions and the ``local_map`` regions issue. It records
      * ``flops``: each local op's FLOPs by ``torch.utils.flop_counter``'s
        formulas (matrix products, convolutions, attention);
      * ``bytes_accessed``: each local op's input and output bytes, ops
        that make no new storage (views, in-place updates) excluded: an
        unfused count, which a fused execution would lower;
      * ``collectives``: (kind, result bytes) of each collective;
      * ``peak_live_bytes``: the most bytes that the tensors made under the
        mode held at once, each counted until its Python
        object is freed. This is not XLA's buffer assignment: it follows
        PyTorch's eager lifetimes, with autograd's saved tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Tuple[str, int]] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0

    def _freed(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation at global shapes: no work on the rank
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if getattr(func, "namespace", None) == "_c10d_functional":
            kind = _KIND.get(func.__name__.split(".")[0])
            if kind is not None:
                self.collectives.append((kind, sum(_nbytes(t) for t in _tensors(out))))
        # an output sharing an input's storage (a view, an in-place op) is no new memory
        seen = {t.untyped_storage()._cdata for t in _tensors(args)}
        new = [t for t in _tensors(out) if t.untyped_storage()._cdata not in seen]
        if new:
            moved = sum(_nbytes(t) for t in _tensors(args)) + sum(_nbytes(t) for t in new)
            self.bytes_accessed += moved
            for t in new:
                n = _nbytes(t)
                self.live_bytes += n
                weakref.finalize(t, self._freed, n)
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return out


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_bytes(ops: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Per-rank wire bytes by collective kind, from a rank's trace of
    (kind, result bytes)."""
    out: Dict[str, float] = {k: 0.0 for k in _MULTIPLIER}
    count: Dict[str, int] = {k: 0 for k in _MULTIPLIER}
    for kind, nbytes in ops:
        out[kind] += nbytes * _MULTIPLIER[kind]
        count[kind] += 1
    out["total"] = sum(out[k] for k in _MULTIPLIER)
    out["ops"] = sum(count.values())
    out.update({f"n_{k}": count[k] for k in count})
    return out


def roofline_terms(
    cost: Dict[str, float], coll: Dict[str, float], n_chips: int
) -> Dict[str, float]:
    """Three roofline terms in seconds (per step, per chip — the SPMD program
    is identical on every chip, so per-chip latency == step latency)."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    cterms = {
        "compute_s": flops / HW["peak_flops"],
        "memory_s": bytes_acc / HW["hbm_bw"],
        "collective_s": coll["total"] / HW["ici_bw"],
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": coll["total"],
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: cterms[k])
    cterms["dominant"] = dom
    denom = max(cterms["compute_s"], cterms["memory_s"], cterms["collective_s"])
    cterms["roofline_fraction_compute"] = (
        cterms["compute_s"] / denom if denom > 0 else 0.0
    )
    return cterms


def ssm_scan_costs(cfg, shape) -> Dict[str, float]:
    """Closed-form FLOPs/bytes of the chunked SSM scan (kernels/ssm_scan.py
    algorithm) for the whole model — GLOBAL totals. The dry-run's analysis
    compiles stub this scan out (XLA cost analysis cannot see through its
    sequential chunk loop), so its true cost is added back here.

    Only train/prefill shapes invoke the scan (decode updates state
    directly). Train counts fwd + remat-fwd + bwd ≈ 4× fwd FLOPs.
    """
    if cfg.family not in ("ssm", "hybrid") or shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    b, s = shape.global_batch, shape.seq_len
    h = cfg.ssm_heads
    n = cfg.ssm_state if not cfg.rwkv else cfg.ssm_head_dim
    p = cfg.ssm_head_dim
    chunk = 64
    nch = -(-s // chunk)
    c = chunk
    per_channel = cfg.rwkv
    if per_channel:
        per_chunk_flops = 5 * c * c * n + 2 * c * c * p + 4 * c * n * p + 6 * c * n
    else:
        per_chunk_flops = 2 * c * c * n + c * c + 2 * c * c * p + 4 * c * n * p + 6 * c * n
    per_chunk_bytes = (4 * c * p + 3 * c * n + 2 * n * p) * 4
    n_layers = cfg.num_layers  # all layers carry the scan in ssm/hybrid
    factor = 4.0 if shape.kind == "train" else 1.0
    total_flops = per_chunk_flops * nch * b * h * n_layers * factor
    total_bytes = per_chunk_bytes * nch * b * h * n_layers * min(factor, 3.0)
    return {"flops": float(total_flops), "bytes": float(total_bytes)}


def model_flops(cfg, shape, n_chips: int) -> float:
    """Idealized model FLOPs per step (GLOBAL, all chips): 6·N_active·D for
    training, 2·N_active·D for prefill, 2·N_active·B (+ attention cache
    reads) for decode."""
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        base = 6.0 * n_active * b * s
        attn = 0.0
        if cfg.family not in ("ssm",):
            windows = cfg.layer_windows(s)
            per_layer = [min(w, s) for w in windows]
            attn = sum(
                6.0 * 2.0 * b * s * w * cfg.num_heads * cfg.head_dim * 0.5
                for w in per_layer
            )
        return base + attn
    if shape.kind == "prefill":
        base = 2.0 * n_active * b * s
        attn = 0.0
        if cfg.family != "ssm":
            windows = cfg.layer_windows(s)
            attn = sum(
                2.0 * 2.0 * b * s * min(w, s) * cfg.num_heads * cfg.head_dim * 0.5
                for w in windows
            )
        return base + attn
    # decode: one token per sequence
    base = 2.0 * n_active * b
    attn = 0.0
    if cfg.family != "ssm":
        windows = cfg.layer_windows(s)
        attn = sum(
            2.0 * 2.0 * b * min(w, s) * cfg.num_heads * cfg.head_dim for w in windows
        )
    return base + attn
