"""Dispatching wrappers for the hand-written kernels.

The device of the tensors decides: a CUDA tensor goes to the kernel, which
raises if it cannot build or launch; a CPU tensor goes to the kernel's plain
PyTorch version. Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import morph_recon, ssm_scan as ssm_scan_kernel
from repro_torch.kernels import ref as kref


def _on_card(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """``use_kernel`` states what the caller expects and raises where the
    device disagrees: ``True`` on a CPU tensor, or ``False`` on a CUDA one."""
    on_card = t.device.type == "cuda"
    if use_kernel is not None and bool(use_kernel) != on_card:
        raise ValueError(
            f"use_kernel={use_kernel} but the tensors are on {t.device}: "
            "the kernel runs exactly for CUDA tensors"
        )
    return on_card


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
    ``block`` and ``inner_iters`` size the TPU kernel's blocks; the CUDA
    kernel fixes its own tile and sweep cap and does not read them.
    """
    if not _on_card(marker, use_kernel):
        return morph_recon.morph_reconstruct_ref(marker, mask, conn=conn)
    return morph_recon.morph_reconstruct_cuda(
        marker.to(torch.float32).contiguous(),
        mask.to(torch.float32).contiguous(),
        conn=conn,
    )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    use_kernel: Optional[bool] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Causal (and sliding-window) grouped-query attention (see
    kernels/flash_attention.py).

    The signature is that of ``repro.kernels.ops.flash_attention``: CPU
    tensors go to the dense ``attention_ref``, as the JAX package's
    non-kernel path does. ``block_q`` and ``block_k`` size the TPU kernel's
    blocks; the CUDA kernel fixes its own tiles and does not read them.
    """
    if not _on_card(q, use_kernel):
        return kref.attention_ref(q, k, v, causal=causal, window=window)
    return flash_kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)


def ssm_scan(
    x: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    use_kernel: Optional[bool] = None,
    chunk: int = 64,
    analysis: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked diagonal-gated linear recurrence (see kernels/ssm_scan.py).

    The signature is that of ``repro.kernels.ops.ssm_scan``. ``analysis``
    swaps in the shape-preserving stub. Like the TPU kernel, the CUDA kernel
    starts from a zero state and raises when given ``h0``.
    """
    if analysis:
        return kref.ssm_scan_stub(x, a, b, c, h0)
    if not _on_card(x, use_kernel):
        return kref.ssm_scan_chunked(x, a, b, c, h0, chunk=chunk)
    if h0 is not None:
        raise NotImplementedError("the ssm_scan kernel requires h0=None (zeros)")
    return ssm_scan_kernel.ssm_scan_cuda(x, a, b, c, chunk=chunk)
