"""Shared neural-net layers (functional style; params are dicts of tensors).

Conventions, as in the JAX package:
  * matrices are used in bf16 (``COMPUTE_DTYPE``), their products summed in
    fp32 and rounded once (:func:`matmul`); norms, biases and decay vectors
    stay fp32;
  * stacked per-layer weights carry a leading L dim; the model walks it
    with a Python loop.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16

__all__ = [
    "COMPUTE_DTYPE",
    "rms_norm",
    "rms_norm_fused",
    "rope_frequencies",
    "apply_rope",
    "matmul",
    "swiglu",
    "dense_ffn",
    "normal_init",
    "normal_stack",
    "token_nll",
    "cross_entropy",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def rms_norm_fused(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 scaled by 1 + ``w``, in x's dtype: :func:`rms_norm`
    in PyTorch's one fused operation (decoding is bound by launches)."""
    return F.rms_norm(x.float(), (x.shape[-1],), 1.0 + w, eps).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(d, theta)).to(x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _column_dim(x: torch.Tensor, w: torch.Tensor):
    """The mesh dim over which ``x @ w`` splits ``w``'s output dim: 'model'
    where it has more than one rank, divides that dim and does not split
    ``x`` already; else None."""
    from torch.distributed.tensor import DTensor, Replicate

    names = tuple(w.device_mesh.mesh_dim_names or ())
    if "model" not in names:
        return None
    m = names.index("model")
    size = w.device_mesh.size(m)
    if size == 1 or w.shape[-1] % size:
        return None
    if isinstance(x, DTensor) and not isinstance(x.placements[m], Replicate):
        return None
    return m


def local_operands(x: torch.Tensor, w: torch.Tensor):
    """On a mesh (DTensors), the operands of ``x @ w`` laid out so that
    each rank's products are whole ones: ``x``'s contracted dim gathered,
    and ``w`` gathered from its at-rest FSDP layout (after its bf16 cast)
    but for its output dim, which is split over 'model' where that divides
    it (column-parallel: each 'model' rank computes its own columns, whole).
    So no partial sum is rounded to bf16 and summed again across ranks in
    the forward. Returns (x, w, the mesh dim of the split or None); plain
    tensors as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(x, DTensor) and Shard(x.dim() - 1) in x.placements:
        x = x.redistribute(x.device_mesh, [Replicate() if p == Shard(x.dim() - 1) else p
                                           for p in x.placements])
    if not isinstance(w, DTensor):
        return x, w, None
    m = _column_dim(x, w)
    pl = [Replicate()] * w.device_mesh.ndim
    if m is not None:
        pl[m] = Shard(w.dim() - 1)
    return x, w.redistribute(w.device_mesh, pl), m


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` rounded to bf16: a bf16 product whose sums run
    in fp32 and are rounded to bf16 once, as XLA computes it on the CPU and
    cuBLAS on the card. PyTorch's bf16 product on the CPU rounds some small
    elements otherwise (about one in ten thousand), which the layers of a
    model at random weights amplify; so CPU tensors multiply in fp32. On a
    mesh each rank computes its 'model' share of the output columns
    (:func:`local_operands`), and the output is all-gathered over 'model'
    into the hidden stream's layout (replicated there, as JAX's
    ``constrain_hidden`` keeps it). In the backward, ``x``'s gradient is
    the sum over 'model' of the ranks' partial products."""
    w = w.to(COMPUTE_DTYPE)
    m = None
    if type(x) is not torch.Tensor or type(w) is not torch.Tensor:
        x, w, m = local_operands(x, w)
    y = (x.float() @ w.float()).to(COMPUTE_DTYPE) if x.device.type == "cpu" else x @ w
    if m is not None:
        from torch.distributed.tensor import Replicate

        y = y.redistribute(y.device_mesh, [Replicate() if i == m else p
                                           for i, p in enumerate(y.placements)])
    return y


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def dense_ffn(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    h = swiglu(matmul(x, w_gate), matmul(x, w_up))
    return matmul(h, w_down)


def normal_init(
    gen: torch.Generator,
    shape: Tuple[int, ...],
    std: Optional[float] = None,
    *,
    dtype: torch.dtype = torch.float32,
    device: Union[None, str, torch.device] = None,
) -> torch.Tensor:
    """Fan-in-scaled normal init, drawn in fp32 from ``gen`` on its device
    and stored as ``dtype``. Fan-in is the second-to-last dim (stacked
    per-layer weights carry leading L/E dims that must not affect scale)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    std = std if std is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device or gen.device)
    return w.mul_(std).to(dtype)


def normal_stack(gen: Optional[torch.Generator], lead: int, shape, std: Optional[float],
                 dtype: torch.dtype, device) -> torch.Tensor:
    """``lead`` stacked :func:`normal_init` draws of ``shape``, each drawn in
    fp32 and stored as ``dtype`` one at a time (the stack is never held in
    fp32); left empty where ``gen`` is None (the meta device)."""
    out = torch.empty((lead, *shape), dtype=dtype, device=device)
    if gen is not None:
        for i in range(lead):
            out[i] = normal_init(gen, tuple(shape), std, dtype=dtype, device=device)
    return out


def token_nll(logits: torch.Tensor, labels: torch.Tensor, *,
              vocab_size: Optional[int] = None) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, in fp32, the
    padded vocab entries (past ``vocab_size``) masked with -1e9."""
    logits = logits.float()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        neg = torch.zeros(logits.shape[-1], dtype=torch.float32, device=logits.device)
        neg[vocab_size:] = -1e9
        logits = logits + neg
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, *, valid: Optional[torch.Tensor] = None,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Mean token cross-entropy in fp32. ``vocab_size`` masks padded vocab
    entries (padded_vocab > vocab_size) with -1e9; ``valid`` masks positions
    and the mean is over ``max(sum(valid), 1)`` of them."""
    nll = token_nll(logits, labels, vocab_size=vocab_size)
    if valid is None:
        return nll.mean()
    v = valid.float()
    return (nll * v).sum() / torch.clamp_min(v.sum(), 1.0)
