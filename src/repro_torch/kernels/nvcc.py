"""Build, count and guard the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. It is built
with ``nvcc`` for ``sm_90a`` into a shared library at first use, into
``_build/`` beside this file, and loaded with ``ctypes``. There is no
fallback: a missing ``nvcc`` or a failed build raises. The kernels compute
forward passes only (:func:`check_forward_only`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import NamedTuple, Optional

__all__ = ["NVCC_FLAGS", "Build", "LaunchCount", "DeviceTotals", "DeviceTotal", "build_library",
           "source"]

_KERNELS = pathlib.Path(__file__).resolve().parent
_BUILD_DIR = _KERNELS / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def source(name: str) -> pathlib.Path:
    return _KERNELS / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); cannot build the CUDA kernels")


class Build(NamedTuple):
    lib: ctypes.CDLL
    seconds: Optional[float]  # None when the library was already built
    ptxas_info: str  # this build's ``-Xptxas -v`` lines and ptxas warnings, spills included


def build_library(name: str) -> Build:
    """Build ``csrc/<name>.cu`` (once per source and flag set) and load it.

    Two threads or processes racing on the first build both compile, into
    temporary files that ``os.replace`` moves atomically onto one name;
    either result is the same library.
    """
    src = source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    target = _BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    seconds, info = None, ""
    if not target.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n{proc.stderr}")
        os.replace(tmp, target)
        seconds = time.perf_counter() - t0
        info = "\n".join(ln for ln in proc.stderr.splitlines()
                         if "ptxas" in ln or "spill" in ln)
    return Build(ctypes.CDLL(str(target)), seconds, info)


class LaunchCount:
    """Thread-safe count of kernel launches, so that a caller can show that
    a run went through the kernel."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0  # guard: _lock

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class DeviceTotals:
    """Int64 counts that a kernel adds to on the card, summed over its
    calls: one buffer of ``n`` on each device, made at the first call
    there. Reading a count waits for the card; a call of the kernel does
    not."""

    def __init__(self, n: int) -> None:
        self._n = n
        self._lock = threading.Lock()
        self._buffers: dict = {}  # guard: _lock

    def buffer(self, device: "torch.device") -> "torch.Tensor":
        """The int64 counts the kernel adds to on ``device``."""
        import torch

        with self._lock:
            if device not in self._buffers:
                self._buffers[device] = torch.zeros(self._n, dtype=torch.int64, device=device)
            return self._buffers[device]

    def value(self, index: int) -> int:
        with self._lock:
            buffers = list(self._buffers.values())
        return sum(int(t[index]) for t in buffers)

    def reset(self, index: int) -> None:
        with self._lock:
            for t in self._buffers.values():
                t[index] = 0


class DeviceTotal:
    """One count of a :class:`DeviceTotals`, summed over devices."""

    def __init__(self, totals: DeviceTotals, index: int) -> None:
        self._totals, self._index = totals, index

    @property
    def value(self) -> int:
        return self._totals.value(self._index)

    def reset(self) -> None:
        self._totals.reset(self._index)


def check_forward_only(kernel: str, *inputs: "torch.Tensor") -> None:
    """Raises where autograd would need a gradient of the kernel's output:
    its result is written into a fresh tensor outside autograd, so the
    gradient would be dropped without a word. Training runs the kernels'
    plain versions (``train=True`` in the models). Raises too on a DTensor:
    a kernel takes local tensors only."""
    import torch

    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor

        if any(isinstance(t, DTensor) for t in inputs):
            raise TypeError(
                f"{kernel}: a DTensor reached the kernel; on a mesh the kernel takes each "
                "rank's local tensors (repro_torch.dist.shard_map_compat, local_map)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{kernel}: an input requires a gradient, and the kernel has no backward pass; "
            "run it under torch.no_grad(), or take the plain version to differentiate"
        )
