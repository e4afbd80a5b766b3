"""Least time of one reconstruction by dilation over ``numel`` float32
pixels: marker and mask read once and the result written once (12 bytes a
pixel) over the memory rate, against one max per neighbour and one min a
pixel over the fp32 rate, whichever is larger (the bytes, at conn 4 and
8). The kernel is ``recon_kernel``, one launch a call."""

from perfbench.rooflines.peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S

KERNELS = ("recon_kernel",)


def bound_s(numel: int, conn: int = 8) -> float:
    return max(12 * numel / HBM_BYTES_PER_S, (conn + 1) * numel / FP32_OPS_PER_S)
