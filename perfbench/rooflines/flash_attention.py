"""Least time of one causal ``flash_attention`` call on the tensor cores
(q, k, v and the output (B, S, H, D) in bf16, S queries over S keys): the
four read or written once over the memory rate, against 4·D operations a
head for each (query, key) pair the causal mask keeps (the two products)
over the bf16 tensor rate, whichever is larger (the operations, at
Zamba2-7B's). The kernel is ``flash_fwd_wgmma_kernel``, one launch a
call."""

from perfbench.rooflines.peaks import HBM_BYTES_PER_S
from perfbench.rooflines.tensor_peaks import BF16_OPS_PER_S

KERNELS = ("flash_fwd_wgmma_kernel",)


def bound_s(b: int, s: int, h: int, d: int) -> float:
    pairs = b * s * (s + 1) // 2
    return max(4 * 2 * b * s * h * d / HBM_BYTES_PER_S, 4 * h * d * pairs / BF16_OPS_PER_S)
