"""Component sizes: the hand-written CUDA kernel for Hopper
(``csrc/component_sizes.cu``) behind :func:`repro_torch.app.ops.component_sizes`
and the size test of ``area_filter`` and ``watershed_split``, its build and
its wrappers.

The kernel replaces no Pallas kernel: the JAX package counts sizes with a
plain scatter-add. From labels in which each pixel of a component holds
its root and the background -1 (``app.ops.label_components``), one call
zeroes an int32 count a pixel, counts each root's pixels (a warp merges
equal labels before its one atomic, the background makes none) and looks
each pixel's size up; its source says what bounds it. Two modes:
:func:`component_sizes_cuda` (the int32 sizes, 0 on the background) and
:func:`size_filter_cuda` (the pixels whose size lies in ``[lo, hi]``, as
bool). Integer counts are exact in any order, so the result is that of the
plain version in :mod:`repro_torch.app.ops` (``torch.bincount``), which CPU
tensors take. It is built by :mod:`repro_torch.kernels.nvcc` at first use.
There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import Build, LaunchCount

__all__ = ["build", "LAUNCHES", "SIZES", "FILTER", "component_sizes_cuda", "size_filter_cuda",
           "bounds"]

SIZES, FILTER = 0, 1  # the kernel's modes
_MAX_PIXELS = 2**31 - 1  # labels and counts are int32
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("component_sizes")
    lib = built.lib
    lib.component_sizes.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p])
    lib.component_sizes.restype = ctypes.c_int
    return built


# one per call of either wrapper (a memset and two launches)
LAUNCHES = LaunchCount()


def bounds(lo: float, hi: Optional[float]) -> Tuple[int, int]:
    """``lo <= size <= hi`` as int32 bounds on an integer size (``hi`` None:
    no upper bound). A size is an integer in [1, 2**31 - 1), so rounding
    ``lo`` up and ``hi`` down and clamping both to int32 keeps exactly the
    sizes the bounds keep."""
    lo_i = min(max(math.ceil(lo), _INT32_MIN), _INT32_MAX)
    hi_i = _INT32_MAX if hi is None else min(max(math.floor(hi), _INT32_MIN), _INT32_MAX)
    return lo_i, hi_i


def component_sizes_cuda(labels: torch.Tensor) -> torch.Tensor:
    """``app.ops.component_sizes`` on the card: each pixel's int32 component
    size, 0 on the background. Takes 2-D, contiguous int32 labels on a CUDA
    device, each -1 or its component's root (the least flat index of the
    component, as ``label_components`` gives it); issues on the current
    stream and does not wait for the card."""
    _check(labels)
    return _launch(SIZES, labels, 0, 0)


def size_filter_cuda(labels: torch.Tensor, lo: float, hi: Optional[float] = None) -> torch.Tensor:
    """``labels >= 0 & lo <= size <= hi`` on the card, as bool (``hi`` None:
    no upper bound): ``mask & (sizes >= lo) & (sizes <= hi)`` for the labels
    of ``mask``, which are -1 exactly off it. Takes what
    :func:`component_sizes_cuda` takes."""
    _check(labels)
    return _launch(FILTER, labels, *bounds(lo, hi))


def _check(t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"labels must be 2-D, got shape {tuple(t.shape)}")
    if t.shape[0] * t.shape[1] >= _MAX_PIXELS:
        raise ValueError(f"labels: {t.shape[0]} x {t.shape[1]} pixels; labels and counts are "
                         f"int32, so h * w must be below {_MAX_PIXELS}")
    if t.device.type != "cuda":
        raise ValueError(f"labels must be on a CUDA device, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"labels must be {torch.int32}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("labels must be contiguous")


def _launch(mode: int, labels: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    nvcc.check_forward_only("component_sizes", labels)
    h, w = labels.shape
    dtype = torch.int32 if mode == SIZES else torch.bool
    out = torch.empty((h, w), dtype=dtype, device=labels.device)
    if h == 0 or w == 0:
        return out
    lib = build().lib
    with torch.cuda.device(labels.device):
        counts = torch.empty(h * w, dtype=torch.int32, device=labels.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.component_sizes(mode, labels.data_ptr(), counts.data_ptr(), out.data_ptr(),
                                  h * w, lo, hi, stream)
        if err != 0:
            raise RuntimeError(f"component_sizes launch failed: CUDA error {err}")
        LAUNCHES.add()
    return out
