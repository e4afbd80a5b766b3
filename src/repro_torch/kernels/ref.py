"""Plain PyTorch morphology: the neighbourhood shift, dilation, erosion and
grayscale reconstruction by dilation. They are the correctness references for
the CUDA kernel in :mod:`repro_torch.kernels.morph_recon` and the helpers the
application layer builds on. Every function here runs on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "neighbors",
    "shift2d",
    "dilate",
    "erode",
    "morph_reconstruct_ref",
]


def neighbors(conn: int) -> Tuple[Tuple[int, int], ...]:
    if conn == 4:
        return ((1, 0), (-1, 0), (0, 1), (0, -1))
    if conn == 8:
        return ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))
    raise ValueError(f"connectivity must be 4 or 8, got {conn}")


def shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Shift a 2D tensor by (dy, dx), filling vacated cells with ``fill``:
    ``out[i, j] = x[i - dy, j - dx]``. Pads on the side the shift vacates,
    then slices the window back out."""
    h, w = x.shape
    padded = F.pad(x, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)), value=fill)
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return padded[y0 : y0 + h, x0 : x0 + w]


def dilate(x: torch.Tensor, conn: int = 8) -> torch.Tensor:
    out = x
    for dy, dx in neighbors(conn):
        out = torch.maximum(out, shift2d(x, dy, dx, float("-inf")))
    return out


def erode(x: torch.Tensor, conn: int = 8) -> torch.Tensor:
    out = x
    for dy, dx in neighbors(conn):
        out = torch.minimum(out, shift2d(x, dy, dx, float("inf")))
    return out


def morph_reconstruct_ref(
    marker: torch.Tensor, mask: torch.Tensor, conn: int = 8
) -> torch.Tensor:
    """Grayscale reconstruction by dilation, iterated to the global fixpoint.

    Invariants: marker ≤ mask is enforced on entry; the result r satisfies
    marker ≤ r ≤ mask and r is the least fixpoint above the marker of
    ``r = min(dilate(r), mask)``. One host sync per step (the ``any``).
    """
    mask = mask.to(torch.float32)
    m = torch.minimum(marker.to(torch.float32), mask)
    while True:
        new = torch.minimum(dilate(m, conn=conn), mask)
        if not bool(torch.any(new != m)):
            return new
        m = new
