"""Morphological reconstruction by dilation: the hand-written CUDA kernel for
Hopper (``csrc/morph_recon.cu``), its build, its wrapper, and its plain
PyTorch versions.

The kernel replaces the Pallas TPU kernel of ``repro.kernels.morph_recon``
(``_recon_sweep_kernel``, ``tile_sweep``, ``morph_reconstruct_pallas``). It
is one persistent, cooperative launch a call that runs rounds over a
worklist of tiles, each visit raster and anti-raster passes with a warp
scan along the rows; the source says how it is laid out and why its result
is exact. It is built by :mod:`repro_torch.kernels.nvcc` at first use. There
is no fallback: a missing ``nvcc``, a failed build or a failed launch raises.

The plain version, :func:`morph_reconstruct_ref`, is the one the dispatch in
:mod:`repro_torch.kernels.ops` runs on CPU tensors; tests and ``chip_smoke.py``
hold the kernel against it. :func:`morph_reconstruct_tiled` repeats the
kernel's schedule (tiles, rounds, worklist, passes) in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import NVCC_FLAGS, Build, DeviceTotal, DeviceTotals, LaunchCount
from repro_torch.kernels.ref import MAX_PASSES, morph_reconstruct_ref, morph_reconstruct_tiled

__all__ = [
    "build", "LAUNCHES", "ROUNDS", "TILE_VISITS", "MAX_PASSES", "TILE",
    "NVCC_FLAGS", "morph_reconstruct_cuda", "morph_reconstruct_ref", "morph_reconstruct_tiled",
]

# The kernel's tile (rows, columns), as csrc/morph_recon.cu fixes it
# (``morph_recon_tile``); MAX_PASSES (from kernels/ref.py) is the passes a
# visit may run before its tile waits for the next round.
TILE = (16, 128)


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("morph_recon")
    lib = built.lib
    lib.morph_recon.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.morph_recon.restype = ctypes.c_int
    lib.morph_recon_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.morph_recon_tile.restype = None
    lib.morph_recon_scratch_ints.argtypes = [ctypes.c_int] * 2
    lib.morph_recon_scratch_ints.restype = ctypes.c_longlong
    lib.morph_recon_max_blocks.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.morph_recon_max_blocks.restype = ctypes.c_int
    return built


@functools.lru_cache(maxsize=None)
def kernel_tile() -> Tuple[int, int, int]:
    """The tile (rows, columns) of the built kernel, and its warps a block
    (each visits tiles on its own)."""
    th, tw, warps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build().lib.morph_recon_tile(ctypes.byref(th), ctypes.byref(tw), ctypes.byref(warps))
    return th.value, tw.value, warps.value


@functools.lru_cache(maxsize=None)
def _max_blocks(conn: int, device: int) -> Tuple[int, int]:
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = build().lib.morph_recon_max_blocks(conn, ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"morph_recon occupancy query failed: CUDA error {err}")
    return blocks.value, smem.value


def max_blocks(conn: int) -> Tuple[int, int]:
    """(the most blocks that can be resident at once for ``conn`` on the
    current device, the shared memory bytes a block takes); asked of the
    card once per connectivity and device."""
    return _max_blocks(conn, torch.cuda.current_device())


# one per call of morph_reconstruct_cuda (one cooperative launch)
LAUNCHES = LaunchCount()
# the kernel's rounds and tile visits, summed over calls on the card
_TOTALS = DeviceTotals(2)
ROUNDS = DeviceTotal(_TOTALS, 0)
TILE_VISITS = DeviceTotal(_TOTALS, 1)


def morph_reconstruct_cuda(
    marker: torch.Tensor, mask: torch.Tensor, conn: int = 8
) -> torch.Tensor:
    """Reconstruction by dilation on the card; see the module docstring.

    Takes float32, 2-D, contiguous tensors on one CUDA device, finite
    (NaN is outside the contract: the kernel's fmaxf/fminf drop NaN where
    torch.maximum propagates it). Launches once on the current stream and
    does not wait for the card.
    """
    return _launch(marker, mask, conn, grid_blocks=0)


def _launch(marker: torch.Tensor, mask: torch.Tensor, conn: int, *, grid_blocks: int):
    """One launch; ``grid_blocks`` 0 sizes the grid to the co-resident limit
    (no more blocks than the tiles need); a number above the limit raises,
    since ``grid.sync()`` would wait for blocks that cannot start."""
    nvcc.check_forward_only("morph_recon", marker, mask)
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
    lib = build().lib
    with torch.cuda.device(marker.device):
        limit, _ = max_blocks(conn)
        th, tw, warps = kernel_tile()
        need = -(-(-(-h // th) * -(-w // tw)) // warps)  # a warp a tile
        grid = grid_blocks or min(need, limit)
        if grid > limit:
            raise RuntimeError(
                f"morph_recon: a grid of {grid} blocks exceeds the {limit} that can be "
                "resident at once; grid.sync would deadlock"
            )
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(mask)
        scratch = torch.zeros(lib.morph_recon_scratch_ints(h, w), dtype=torch.int32,
                              device=marker.device)
        totals = _TOTALS.buffer(marker.device)
        err = lib.morph_recon(marker.data_ptr(), mask.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), totals.data_ptr(), h, w, conn, MAX_PASSES,
                              grid, stream)
        if err != 0:
            raise RuntimeError(f"morph_recon launch failed: CUDA error {err}")
        LAUNCHES.add()
    return out
