"""Label propagation to a fixpoint: the hand-written CUDA kernel for Hopper
(``csrc/label_prop.cu``) behind the label loops of
:mod:`repro_torch.app.ops`, its build and its wrappers.

The kernel replaces no Pallas kernel: the JAX package runs these loops as
plain ``jax.lax.while_loop``'s. It runs one loop to its fixpoint in one
persistent, cooperative launch, two fused steps between grid barriers,
with no host round trip and no padded copies; its source says how it is
laid out and what bounds it. Two modes:
:func:`label_components_cuda` (``app.ops.label_components``) and
:func:`flood_cuda` (the seeded flood of ``app.ops.watershed_split``). Every
step reads the labels of the step before, so the result and the number of
steps are those of the Python loops in :mod:`repro_torch.app.ops`, which
run on CPU tensors and are the kernel's plain versions. It is built by
:mod:`repro_torch.kernels.nvcc` at first use. There is no fallback: a
missing ``nvcc``, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import Build, DeviceTotal, DeviceTotals, LaunchCount

__all__ = ["build", "LAUNCHES", "STEPS", "TILE", "COMPONENT", "FLOOD", "label_components_cuda",
           "flood_cuda", "max_blocks"]

# The kernel's tile (rows, columns), as csrc/label_prop.cu fixes it
# (``label_prop_tile``).
TILE = (32, 128)
COMPONENT, FLOOD = 0, 1  # the kernel's modes
_MAX_PIXELS = 2**31 - 1  # labels and the flood's big value, h * w, are int32


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("label_prop")
    lib = built.lib
    lib.label_prop.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
    lib.label_prop.restype = ctypes.c_int
    lib.label_prop_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.label_prop_tile.restype = None
    lib.label_prop_max_blocks.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.label_prop_max_blocks.restype = ctypes.c_int
    return built


@functools.lru_cache(maxsize=None)
def kernel_tile() -> Tuple[int, int, int]:
    """The built kernel's tile (rows, columns) and its threads a block."""
    th, tw, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build().lib.label_prop_tile(ctypes.byref(th), ctypes.byref(tw), ctypes.byref(threads))
    return th.value, tw.value, threads.value


@functools.lru_cache(maxsize=None)
def _max_blocks(mode: int, conn: int, device: int) -> int:
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        err = build().lib.label_prop_max_blocks(mode, conn, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"label_prop occupancy query failed: CUDA error {err}")
    return blocks.value


def max_blocks(mode: int, conn: int) -> int:
    """The most blocks of ``mode`` and ``conn`` that can be resident at once
    on the current device; asked of the card once per mode, connectivity
    and device."""
    return _max_blocks(mode, conn, torch.cuda.current_device())


# one per call of either wrapper (one cooperative launch)
LAUNCHES = LaunchCount()
# the steps the kernel ran, summed over calls on the card
_TOTALS = DeviceTotals(1)
STEPS = DeviceTotal(_TOTALS, 0)


def label_components_cuda(mask: torch.Tensor, conn: int = 8) -> torch.Tensor:
    """``app.ops.label_components`` on the card: int32 labels, each pixel
    of ``mask`` the least flat index of its component, -1 on the
    background. Takes a 2-D, contiguous bool tensor on a CUDA device;
    launches once on the current stream and does not wait for the card."""
    _check(mask, "mask", torch.bool, conn)
    return _launch(COMPONENT, mask, None, conn, grid_blocks=0)


def flood_cuda(seeds: torch.Tensor, pre: torch.Tensor, conn: int = 8) -> torch.Tensor:
    """The seeded flood of ``app.ops.watershed_split`` on the card: from the
    int32 ``seeds`` (each in [0, h*w], h*w meaning unlabelled), each step
    gives an unlabelled pixel of ``pre`` the least label among its
    neighbours, until a step labels none. Takes 2-D, contiguous tensors of
    one shape on one CUDA device; launches once on the current stream and
    does not wait for the card."""
    _check(seeds, "seeds", torch.int32, conn)
    _check(pre, "pre", torch.bool, conn)
    if pre.shape != seeds.shape or pre.device != seeds.device:
        raise ValueError(f"seeds {tuple(seeds.shape)} on {seeds.device} and pre "
                         f"{tuple(pre.shape)} on {pre.device} must match")
    return _launch(FLOOD, pre, seeds, conn, grid_blocks=0)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, conn: int) -> None:
    if conn not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {conn}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.shape[0] * t.shape[1] >= _MAX_PIXELS:
        raise ValueError(f"{name}: {t.shape[0]} x {t.shape[1]} pixels; labels are int32, "
                         f"so h * w must be below {_MAX_PIXELS}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(mode: int, mask: torch.Tensor, seeds: Optional[torch.Tensor], conn: int, *,
            grid_blocks: int) -> torch.Tensor:
    """One launch; ``grid_blocks`` 0 sizes the grid to the co-resident limit
    (no more blocks than tiles); a number above the limit raises, since
    ``grid.sync()`` would wait for blocks that cannot start."""
    nvcc.check_forward_only("label_prop", mask)
    h, w = mask.shape
    out = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    if h == 0 or w == 0:
        return out
    lib = build().lib
    with torch.cuda.device(mask.device):
        limit = max_blocks(mode, conn)
        th, tw, _ = kernel_tile()
        grid = grid_blocks or min(-(-h // th) * -(-w // tw), limit)
        if grid > limit:
            raise RuntimeError(
                f"label_prop: a grid of {grid} blocks exceeds the {limit} that can be "
                "resident at once; grid.sync would deadlock"
            )
        stream = torch.cuda.current_stream().cuda_stream
        scratch = torch.empty(h * w + 4, dtype=torch.int32, device=mask.device)
        totals = _TOTALS.buffer(mask.device)
        err = lib.label_prop(mode, mask.data_ptr(), seeds.data_ptr() if seeds is not None else None,
                             out.data_ptr(), scratch.data_ptr(), totals.data_ptr(), h, w, conn,
                             grid, stream)
        if err != 0:
            raise RuntimeError(f"label_prop launch failed: CUDA error {err}")
        LAUNCHES.add()
    return out
