"""Causal, sliding-window, grouped-query attention (FlashAttention's
forward pass): the two hand-written CUDA kernels for Hopper, their builds,
launch counts and wrappers.

- ``csrc/flash_attention_wgmma.cu``, the tensor-core kernel (``wgmma`` fed
  by TMA), takes bf16 inputs with a head dim that is a multiple of 16 and at
  most 128 (:func:`flash_attention_wgmma`);
- ``csrc/flash_attention.cu``, the CUDA-core kernel in IEEE fp32, takes
  everything else: fp32 inputs, whose reference bar of 2e-5 only fp32
  products meet, and bf16 with any other head dim
  (:func:`flash_attention_simt`).

:func:`flash_attention_cuda` chooses between them by
:func:`uses_tensor_cores` (dtype and head dim); it is a dispatch, not a
fallback. The kernels replace the Pallas TPU kernel of
``repro.kernels.flash_attention`` (``_fa_kernel``, ``flash_attention_pallas``);
the sources say how they are laid out and what bounds them. They are built by
:mod:`repro_torch.kernels.nvcc` at first use. A missing ``nvcc``, a failed
build, an input the chosen kernel does not take, or a failed launch raises.

The plain versions, :func:`attention_ref` (dense, the oracle) and
:func:`flash_attention_blocked` (each kernel's arithmetic, block by block),
live in :mod:`repro_torch.kernels.ref`; the dispatch in
:mod:`repro_torch.kernels.ops` and the model's
:func:`repro_torch.models.attention.blocked_attention` send CUDA tensors
here, and tests and ``chip_smoke.py`` hold the kernels against both.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import Build, LaunchCount
from repro_torch.kernels.ref import attention_ref, flash_attention_blocked, uses_tensor_cores

__all__ = ["build", "build_wgmma", "LAUNCHES", "WGMMA_LAUNCHES", "flash_attention_cuda",
           "flash_attention_simt", "flash_attention_wgmma", "uses_tensor_cores",
           "shared_memory_bytes", "wgmma_shared_memory_bytes", "tma_layout_error",
           "attention_ref", "flash_attention_blocked"]

MAX_HEAD_DIM = 256  # the CUDA-core kernel: sixteen output columns a thread (csrc/flash_attention.cu)
WGMMA_MAX_HEAD_DIM = 128  # the tensor-core kernel's tiles (csrc/flash_attention_wgmma.cu)
WGMMA_THREADS = 384  # two consumer warpgroups and a producer (csrc/flash_attention_wgmma.cu)


def shared_memory_bytes(d: int) -> int:
    """Dynamic shared memory a block takes at head dim ``d``: the q, K and V
    tiles of 64 rows of ``d | 1`` floats and the 64×65 probability tile
    (csrc/flash_attention.cu, ``smem_bytes``; the library's
    ``flash_attention_smem`` gives the source's own number)."""
    return 4 * (3 * 64 * (d | 1) + 64 * 65)


def wgmma_shared_memory_bytes(d: int) -> int:
    """Dynamic shared memory a CTA of the tensor-core kernel takes at head
    dim ``d``: the q tile (128 rows) and a ring of K and V tiles (128 rows),
    three stages deep up to D = 112 and two above, in 16-column slabs of
    32-byte rows; an mbarrier for q and two a stage; and 1 KB of slack to
    align the tiles to 1024 bytes (csrc/flash_attention_wgmma.cu,
    ``smem_bytes``; the library's ``flash_attention_wgmma_smem`` gives the
    source's own number)."""
    slabs = d // 16
    stages = 3 if slabs <= 7 else 2
    return slabs * (128 * 32 + 2 * stages * 128 * 32) + 8 * (1 + 2 * stages) + 1024


def tma_layout_error(t: torch.Tensor) -> Optional[str]:
    """Why a (B, S, heads, D) tensor cannot be read by the tensor-core
    kernel's TMA loads, or None: bf16, D contiguous, a 16-byte aligned start
    and the other strides (those of dims longer than 1) multiples of 16
    bytes."""
    if t.dtype != torch.bfloat16:
        return f"dtype {t.dtype}, not bfloat16"
    if t.stride(3) != 1:
        return f"head dim stride {t.stride(3)}, not 1"
    if t.data_ptr() % 16:
        return f"start address {t.data_ptr():#x} not 16-byte aligned"
    for dim in range(3):
        if t.shape[dim] > 1 and (2 * t.stride(dim)) % 16:
            return f"stride {t.stride(dim)} of dim {dim} is not a multiple of 8 elements"
    return None


def _tma_strides(t: torch.Tensor):
    """The element strides of t's (B, S, heads) dims for a tensor map; a
    dim of length 1 is never stepped over, so it gets the stride its inner
    neighbour would give it."""
    out, inner = [0, 0, 0], t.shape[3]
    for dim in (2, 1, 0):
        out[dim] = t.stride(dim) if t.shape[dim] > 1 else inner
        inner = out[dim] * t.shape[dim]
    return out + [1]


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the CUDA-core kernel's
    library."""
    built = nvcc.build_library("flash_attention")
    fn = built.lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float]
        + [ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    built.lib.flash_attention_smem.argtypes = (ctypes.c_int,)
    built.lib.flash_attention_smem.restype = ctypes.c_longlong
    return built


@functools.lru_cache(maxsize=None)
def build_wgmma() -> Build:
    """Build (once per source and flag set) and load the tensor-core
    kernel's library."""
    built = nvcc.build_library("flash_attention_wgmma")
    fn = built.lib.flash_attention_wgmma_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
        + [ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    built.lib.flash_attention_wgmma_smem.argtypes = (ctypes.c_int,)
    built.lib.flash_attention_wgmma_smem.restype = ctypes.c_longlong
    return built


# one per launch of each kernel
LAUNCHES = LaunchCount()  # the CUDA-core kernel
WGMMA_LAUNCHES = LaunchCount()  # the tensor-core kernel


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
) -> torch.Tensor:
    """Attention on the card: the tensor-core kernel where
    :func:`uses_tensor_cores` holds (bf16, D a multiple of 16 up to 128),
    the CUDA-core kernel otherwise.

    q (B, Sq, H, D) and k, v (B, Sk, KV, D) in one dtype, float32 or
    bfloat16, on one CUDA device, with H a multiple of KV and D at most 256.
    ``q_offset`` is the absolute position of q's first row. Returns
    (B, Sq, H, D) in q's dtype. Launches once on the current stream and does
    not synchronise.
    """
    _check(q, k, v)
    kernel = flash_attention_wgmma if uses_tensor_cores(q.dtype, q.shape[3]) else flash_attention_simt
    return kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def flash_attention_simt(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
) -> torch.Tensor:
    """The CUDA-core kernel, ``csrc/flash_attention.cu``: any strides, fp32
    or bf16, D at most 256. The kernel fixes its own 64×64 tiles; the result
    does not depend on them."""
    _check(q, k, v)
    bsz, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dev = q.device
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


def flash_attention_wgmma(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
) -> torch.Tensor:
    """The tensor-core kernel, ``csrc/flash_attention_wgmma.cu``: bf16 with
    D a multiple of 16 up to 128, laid out for TMA (:func:`tma_layout_error`).
    Raises on anything else; it makes no copy. Its arithmetic is
    :func:`flash_attention_blocked`'s for such inputs: probabilities rounded
    to bf16 before the P·V product."""
    _check(q, k, v)
    bsz, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if not uses_tensor_cores(q.dtype, d):
        raise ValueError(f"the tensor-core kernel takes bf16 with D a multiple of 16 up to "
                         f"{WGMMA_MAX_HEAD_DIM}, got {q.dtype} with D {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        why = tma_layout_error(t)
        if why:
            raise ValueError(f"{name} cannot be loaded by TMA: {why}")
    dev = q.device
    fn = build_wgmma().lib.flash_attention_wgmma_fwd
    strides = (ctypes.c_longlong * 12)(*_tma_strides(q), *_tma_strides(k), *_tma_strides(v))
    with torch.cuda.device(dev):
        out = torch.empty((bsz, sq, h, d), dtype=q.dtype, device=dev)
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bsz, sq, sk, h, kv, d, int(bool(causal)), int(window is not None), int(window or 0),
            int(q_offset), 1.0 / math.sqrt(d), ctypes.addressof(strides),
            torch.cuda.current_stream().cuda_stream,
        )
        if err == -1:
            raise RuntimeError("flash_attention_wgmma_fwd: libcuda has no cuTensorMapEncodeTiled")
        if err <= -1000:
            raise RuntimeError(f"flash_attention_wgmma_fwd: cuTensorMapEncodeTiled refused a "
                               f"tensor map: CUresult {-err - 1000}")
        if err != 0:
            raise RuntimeError(f"flash_attention_wgmma_fwd launch failed: CUDA error {err}")
        WGMMA_LAUNCHES.add()
    return out
