"""Causal, sliding-window, grouped-query attention (FlashAttention-2's
forward pass): the hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``), its build, its launch count and its wrapper.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.flash_attention``
(``_fa_kernel``, ``flash_attention_pallas``); the source says how it is laid
out and what bounds it. It is built by :mod:`repro_torch.kernels.nvcc` at
first use. There is no fallback: a missing ``nvcc``, a failed build or a
failed launch raises.

The plain versions, :func:`attention_ref` (dense, the oracle) and
:func:`flash_attention_blocked` (the kernel's arithmetic, block by block),
live in :mod:`repro_torch.kernels.ref`; the dispatch in
:mod:`repro_torch.kernels.ops` and the model's
:func:`repro_torch.models.attention.blocked_attention` send CUDA tensors
here, and tests and ``chip_smoke.py`` hold the kernel against both.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import Build, LaunchCount
from repro_torch.kernels.ref import attention_ref, flash_attention_blocked

__all__ = ["build", "LAUNCHES", "flash_attention_cuda", "shared_memory_bytes", "attention_ref",
           "flash_attention_blocked"]

MAX_HEAD_DIM = 128  # eight output columns a thread (csrc/flash_attention.cu)


def shared_memory_bytes(d: int) -> int:
    """Dynamic shared memory a block takes at head dim ``d``: the q, K and V
    tiles of 64 rows of ``d | 1`` floats and the 64×65 probability tile."""
    return 4 * (3 * 64 * (d | 1) + 64 * 65)


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("flash_attention")
    fn = built.lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float]
        + [ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return built


# one per call of flash_attention_cuda
LAUNCHES = LaunchCount()


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
) -> torch.Tensor:
    """Attention on the card; see ``csrc/flash_attention.cu``.

    q (B, Sq, H, D) and k, v (B, Sk, KV, D) in one dtype, float32 or
    bfloat16, on one CUDA device, in any strides, with H a multiple of KV
    and D at most 128. ``q_offset`` is the absolute position of q's first
    row. Returns (B, Sq, H, D) in q's dtype. The kernel fixes its own 64×64
    tiles; the result does not depend on them. Launches once on the current
    stream and does not synchronise.
    """
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(
            f"q, k and v must be on one CUDA device, got {q.device}, {k.device} and {v.device}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k and v must share float32 or bfloat16, got {q.dtype}, {k.dtype} and {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"q (B,Sq,H,D) and k, v (B,Sk,KV,D) required, got {tuple(q.shape)}, "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    bsz, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if min(bsz, sq, sk, h, kv, d) < 1 or h % kv or d > MAX_HEAD_DIM:
        raise ValueError(
            f"need non-empty shapes, H a multiple of KV and D <= {MAX_HEAD_DIM}: "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}"
        )
    fn = build().lib.flash_attention_fwd
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    with torch.cuda.device(dev):
        out = torch.empty((bsz, sq, h, d), dtype=q.dtype, device=dev)
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), bsz, sq, sk, h, kv, d, int(bool(causal)),
            int(window is not None), int(window or 0), int(q_offset), 1.0 / math.sqrt(d),
            ctypes.addressof(strides), torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
        LAUNCHES.add()
    return out
