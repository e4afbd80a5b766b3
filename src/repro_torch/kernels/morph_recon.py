"""Morphological reconstruction by dilation: the hand-written CUDA kernel for
Hopper (``csrc/morph_recon.cu``), its build, its wrapper, and its plain
PyTorch version.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.morph_recon``
(``_recon_sweep_kernel``, ``tile_sweep``, ``morph_reconstruct_pallas``). The
source says how it is laid out and why its result is exact. It is built by
:mod:`repro_torch.kernels.nvcc` at first use. There is no fallback: a
missing ``nvcc``, a failed build or a failed launch raises.

The plain version, :func:`morph_reconstruct_ref`, is the one the dispatch in
:mod:`repro_torch.kernels.ops` runs on CPU tensors; tests and ``chip_smoke.py``
hold the kernel against it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import NVCC_FLAGS, Build, LaunchCount
from repro_torch.kernels.ref import morph_reconstruct_ref

__all__ = ["build", "LAUNCHES", "NVCC_FLAGS", "morph_reconstruct_cuda", "morph_reconstruct_ref"]

# Sweeps a tile may run in one launch before it hands over to the next.
MAX_INNER = 64


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("morph_recon")
    fn = built.lib.morph_recon_sweep
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


# one per outer fixpoint step of morph_reconstruct_cuda
LAUNCHES = LaunchCount()


def morph_reconstruct_cuda(
    marker: torch.Tensor, mask: torch.Tensor, conn: int = 8
) -> torch.Tensor:
    """Reconstruction by dilation on the card; see the module docstring.

    Takes float32, 2-D, contiguous tensors on one CUDA device, finite
    (NaN is outside the contract: the kernel's fmaxf/fminf drop NaN where
    torch.maximum propagates it). Launches on the current stream and
    synchronises once per launch, to read the changed-flag.
    """
    if marker.device.type != "cuda" or mask.device != marker.device:
        raise ValueError(
            f"marker and mask must be on one CUDA device, got {marker.device} and {mask.device}"
        )
    if marker.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError(f"float32 required, got {marker.dtype} and {mask.dtype}")
    if marker.dim() != 2 or marker.shape != mask.shape:
        raise ValueError(f"two equal 2-D shapes required, got {marker.shape} and {mask.shape}")
    if not (marker.is_contiguous() and mask.is_contiguous()):
        raise ValueError("marker and mask must be contiguous")
    if conn not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {conn}")
    h, w = marker.shape
    if h == 0 or w == 0:
        return torch.empty_like(mask)
    fn = build().lib.morph_recon_sweep
    with torch.cuda.device(marker.device):
        stream = torch.cuda.current_stream().cuda_stream
        bufs = (torch.empty_like(mask), torch.empty_like(mask))
        changed = torch.empty(1, dtype=torch.int32, device=marker.device)
        src = marker
        step = 0
        while True:
            dst = bufs[step % 2]
            err = fn(
                src.data_ptr(), mask.data_ptr(), dst.data_ptr(), changed.data_ptr(),
                h, w, conn, MAX_INNER, stream,
            )
            if err != 0:
                raise RuntimeError(f"morph_recon_sweep launch failed: CUDA error {err}")
            LAUNCHES.add()
            if int(changed.item()) == 0:
                return dst
            src = dst
            step += 1
