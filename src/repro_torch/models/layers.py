"""Shared neural-net layers (functional style; params are dicts of tensors).

Conventions, as in the JAX package:
  * matrices are used in bf16 (``COMPUTE_DTYPE``); norms, biases and decay
    vectors stay fp32;
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
    "rope_frequencies",
    "apply_rope",
    "swiglu",
    "dense_ffn",
    "normal_init",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


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


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def dense_ffn(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    dt = COMPUTE_DTYPE
    h = swiglu(x @ w_gate.to(dt), x @ w_up.to(dt))
    return h @ w_down.to(dt)


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
