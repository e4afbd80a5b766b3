"""Dispatching wrappers for the hand-written kernels.

The device of the tensors decides: a CUDA tensor goes to the kernel, which
raises if it cannot build or launch; a CPU tensor goes to the kernel's plain
PyTorch version. Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import morph_recon


def morph_reconstruct(
    marker: torch.Tensor,
    mask: torch.Tensor,
    *,
    conn: int = 8,
    use_kernel: Optional[bool] = None,
    block: Tuple[int, int] = (256, 256),
    inner_iters: int = 8,
) -> torch.Tensor:
    """Morphological reconstruction by dilation (see kernels/morph_recon.py).

    The signature is that of ``repro.kernels.ops.morph_reconstruct``.
    ``use_kernel`` states what the caller expects and raises where the
    device disagrees: ``True`` on a CPU tensor, or ``False`` on a CUDA one.
    ``block`` and ``inner_iters`` size the TPU kernel's blocks; the CUDA
    kernel fixes its own tile and sweep cap and does not read them.
    """
    on_card = marker.device.type == "cuda"
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(
            f"use_kernel={use_kernel} but the tensors are on {marker.device}: "
            "the kernel runs exactly for CUDA tensors"
        )
    if not on_card:
        return morph_recon.morph_reconstruct_ref(marker, mask, conn=conn)
    return morph_recon.morph_reconstruct_cuda(
        marker.to(torch.float32).contiguous(),
        mask.to(torch.float32).contiguous(),
        conn=conn,
    )
