"""Production meshes over the ranks of a ``torch.distributed`` world: the
JAX package's ``repro.launch.mesh``.

Defined as FUNCTIONS (importing this module starts no process group). The
production pod is 16×16 = 256 ranks; multi-pod adds a leading 'pod' axis
(2 × 256 = 512). JAX's devices exist without set-up; torch's ranks do not:
the world comes from ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), or, where there is none and the mesh
needs one rank, it is a world of one (NCCL on the card, gloo on the CPU).
When the world has more ranks than a mesh needs, the first ``prod(shape)``
are used, and every rank of the world must make the same call.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

__all__ = ["make_production_mesh", "make_mesh_from_devices"]


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _ranks_available() -> int:
    """The ranks a mesh can use: the live world's, ``torchrun``'s
    ``WORLD_SIZE`` before it is started, else 1 (a world of one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _start_world(device_type: str) -> None:
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = _backend(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "WORLD_SIZE" in os.environ:  # torchrun's environment
        dist.init_process_group(backend, init_method="env://")
    else:  # a world of one needs no rendezvous
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh_from_devices(
    shape: Tuple[int, ...], axes: Tuple[str, ...], devices: Optional[Sequence[int]] = None, *,
    device_type: Optional[str] = None,
):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    ranks ``devices`` (default: the world's, in order). ``device_type``:
    ``"cuda"`` (NCCL) unless given; a live world's backend decides it
    otherwise (gloo: ``"cpu"``). Raises ``ValueError`` naming the ranks
    needed and available."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    need = math.prod(shape)
    ranks = list(devices) if devices is not None else list(range(_ranks_available()))
    if len(ranks) < need:
        raise ValueError(
            f"mesh {tuple(shape)} needs {need} ranks, only {len(ranks)} available "
            f"(start the job with torchrun --nproc-per-node ... so that WORLD_SIZE >= {need})")
    if device_type is None:
        if dist.is_available() and dist.is_initialized():
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        else:
            from repro_torch.device import resolve_device

            device_type = resolve_device(None).type  # the card, raising without one
    _start_world(device_type)
    mesh = torch.tensor(ranks[:need], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_from_devices(shape, axes, device_type=device_type)
