"""The chunked diagonal-gated linear recurrence (RWKV-6 and Mamba2 time
mixing): the hand-written CUDA kernel for Hopper (``csrc/ssm_scan.cu``), its
build, its launch count and its wrapper.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.ssm_scan``
(``_ssm_chunk_kernel``, ``ssm_scan_pallas``); the source says how it is laid
out and what bounds it. It is built by :mod:`repro_torch.kernels.nvcc` at
first use. There is no fallback: a missing ``nvcc``, a failed build or a
failed launch raises.

The plain versions, :func:`ssm_scan_ref` (one token at a time) and
:func:`ssm_scan_chunked` (the kernel's arithmetic), live in
:mod:`repro_torch.kernels.ref`; the dispatch in :mod:`repro_torch.kernels.ops`
runs the chunked one on CPU tensors, and tests and ``chip_smoke.py`` hold
the kernel against both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import Build, LaunchCount
from repro_torch.kernels.ref import ssm_scan_chunked, ssm_scan_ref

__all__ = ["build", "LAUNCHES", "ssm_scan_cuda", "ssm_scan_chunked", "ssm_scan_ref"]


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("ssm_scan")
    fn = built.lib.ssm_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return built


# one per call of ssm_scan_cuda
LAUNCHES = LaunchCount()


def ssm_scan_cuda(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, chunk: int = 64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_final)`` of the recurrence on the card, with a zero initial
    state; see ``csrc/ssm_scan.cu``.

    x (B, S, H, P), b and c (B, S, H, N) in one dtype, float32 or bfloat16;
    a float32, (B, S, H, N) or (B, S, H); all on one CUDA device, in any
    strides. Returns y (B, S, H, P) in x's dtype and h_final (B, H, N, P)
    in float32. Launches once on the current stream and does not
    synchronise.
    """
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (a, b, c)):
        raise ValueError(
            f"x, a, b and c must be on one CUDA device, got {x.device}, {a.device}, "
            f"{b.device} and {c.device}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(
            f"x, b and c must share float32 or bfloat16, got {x.dtype}, {b.dtype} and {c.dtype}"
        )
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape or b.shape[:3] != x.shape[:3]:
        raise ValueError(
            f"x (B,S,H,P) and b, c (B,S,H,N) required, got {tuple(x.shape)}, "
            f"{tuple(b.shape)} and {tuple(c.shape)}"
        )
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if a.dim() == 3:
        a = a.unsqueeze(-1).expand(bsz, s, h, n)  # stride 0 over N: nothing copied
    if a.shape != b.shape:
        raise ValueError(f"a must be (B,S,H) or (B,S,H,N), got {tuple(a.shape)}")
    if min(bsz, s, h, n, p) < 1 or chunk < 1:
        raise ValueError(f"empty shape or chunk: x {tuple(x.shape)}, N {n}, chunk {chunk}")
    fn = build().lib.ssm_scan_fwd
    strides = (ctypes.c_longlong * 16)(*x.stride(), *a.stride(), *b.stride(), *c.stride())
    with torch.cuda.device(dev):
        y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
        hout = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
        err = fn(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            hout.data_ptr(), int(x.dtype == torch.bfloat16), bsz, s, h, n, p, chunk,
            ctypes.addressof(strides), torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"ssm_scan_fwd launch failed: CUDA error {err}")
        LAUNCHES.add()
    return y, hout
