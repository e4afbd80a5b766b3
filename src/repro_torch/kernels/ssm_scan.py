"""The chunked diagonal-gated linear recurrence (RWKV-6 and Mamba2 time
mixing): the hand-written CUDA kernel for Hopper (``csrc/ssm_scan.cu``), its
build, its launch count and its wrapper.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.ssm_scan``
(``_ssm_chunk_kernel``, ``ssm_scan_pallas``); the source says how it is laid
out and what bounds it. It is built by :mod:`repro_torch.kernels.nvcc` at
first use. There is no fallback: a missing ``nvcc``, a failed build or a
failed launch raises.

The plain versions, :func:`ssm_scan_ref` (one token at a time),
:func:`ssm_scan_chunked` (the JAX package's chunked arithmetic) and
:func:`ssm_scan_three_pass` (the kernel's passes: local states, the chunk
scan, the outputs), live in :mod:`repro_torch.kernels.ref`; the dispatch in
:mod:`repro_torch.kernels.ops` runs the chunked one on CPU tensors, and
tests and ``chip_smoke.py`` hold the kernel against all three.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import Build, LaunchCount
from repro_torch.kernels.ref import ssm_scan_chunked, ssm_scan_ref, ssm_scan_three_pass

__all__ = ["build", "LAUNCHES", "ssm_scan_cuda", "ssm_scan_chunked", "ssm_scan_ref",
           "ssm_scan_three_pass", "scratch_shapes", "shared_memory_bytes", "blocks_per_sm"]

THREADS = 256  # a block of each pass (csrc/ssm_scan.cu)
SM_SHARED_BYTES = 233_472  # shared memory of an H100 SM (228 KB)
BLOCK_SHARED_LIMIT = 232_448  # the most one block may take (227 KB)


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def scratch_shapes(b: int, s: int, h: int, n: int, p: int, chunk: int, per_head: bool):
    """Shapes of the fp32 scratch the wrapper allocates: each chunk's state
    (B, H, chunks, N, P), which the carry pass turns into its carry-in
    state, and each chunk's decay exp(L_last) (B, H, chunks, 1 or N)."""
    chunks = -(-s // min(chunk, s))
    return (b, h, chunks, n, p), (b, h, chunks, 1 if per_head else n)


def shared_memory_bytes(n: int, p: int, chunk: int, per_head: bool) -> Tuple[int, int]:
    """Dynamic shared memory a block of the state pass and of the output
    pass takes (csrc/ssm_scan.cu: ``state_smem``, ``output_smem``; the
    library's ``ssm_scan_smem`` gives the source's own numbers), chunk
    already cut to the sequence length."""
    lt, p4, n4, nl = _round4(chunk) + 4, _round4(p), _round4(n), 1 if per_head else n
    state = 4 * (chunk * p4 + chunk * n4 + nl * lt)
    output = 4 * (chunk * p4 + n * lt + n * max(lt, p4) + chunk * lt + nl * lt)
    return state, output


def blocks_per_sm(smem_bytes: int, threads: int = THREADS) -> int:
    """Blocks of one pass that fit an H100 SM by shared memory (1 KB of it
    reserved a block) and by threads (2048 an SM); registers not counted."""
    return min(SM_SHARED_BYTES // (smem_bytes + 1024), 2048 // threads)


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("ssm_scan")
    fn = built.lib.ssm_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    built.lib.ssm_scan_smem.argtypes = [ctypes.c_int] * 5
    built.lib.ssm_scan_smem.restype = ctypes.c_longlong
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
    in float32. A decay that is (B, S, H), or (B, S, H, N) with a zero
    stride over N, takes the per-head path. Allocates the scratch of
    :func:`scratch_shapes` and runs the kernel's three passes on the current
    stream (one count of ``LAUNCHES``); does not synchronise. Raises when
    a pass needs more shared memory than a block may take
    (:func:`shared_memory_bytes`), as the launch refuses it.
    """
    nvcc.check_forward_only("ssm_scan", x, a, b, c)
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
    per_head = a.stride(3) == 0
    state_shape, decay_shape = scratch_shapes(bsz, s, h, n, p, chunk, per_head)
    fn = build().lib.ssm_scan_fwd
    strides = (ctypes.c_longlong * 16)(*x.stride(), *a.stride(), *b.stride(), *c.stride())
    with torch.cuda.device(dev):
        y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
        hout = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
        state = torch.empty(state_shape, dtype=torch.float32, device=dev)
        decay = torch.empty(decay_shape, dtype=torch.float32, device=dev)
        err = fn(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            hout.data_ptr(), state.data_ptr(), decay.data_ptr(),
            int(x.dtype == torch.bfloat16), int(per_head), bsz, s, h, n, p, chunk,
            ctypes.addressof(strides), torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"ssm_scan_fwd launch failed: CUDA error {err}")
        LAUNCHES.add()
    return y, hout
