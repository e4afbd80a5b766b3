"""Atomic, async checkpointing of trees of tensors, in the JAX package's
on-disk layout (``repro.checkpoint.checkpointer``), so that either package
reads what the other wrote:

    <dir>/step_<N>/
        manifest.json   — step, metadata, and for each leaf its key, file,
                          shape and dtype
        leaf_<i>.npy    — one file per leaf, numbered in the JAX package's
                          leaf order (dicts by sorted key: repro_torch.tree)

A leaf's key joins its dict keys and list indices with ``/``. Properties:
  * atomic — written to ``step_<N>.tmp`` then ``os.rename``d; a crashed
    writer never leaves a readable-but-corrupt checkpoint;
  * async — ``save_async`` copies every leaf to host memory before it
    returns and writes in a background thread;
  * ``keep`` — only the newest ``keep`` steps stay on disk;
  * resumable — the manifest carries metadata (the token pipeline's state).

Leaves are written as numpy arrays: fp32 masters, moments and the int32
step count. numpy has no bfloat16, so a bf16 leaf raises rather than being
stored in another dtype.

On a mesh checkpoints stay mesh-agnostic, as the JAX package's are: a
DTensor leaf is gathered to its global value (``full_tensor``, a
collective that every rank calls), only rank 0 of the process group writes,
and every rank waits for the write before ``save`` (or the ``wait`` after
``save_async``) returns. ``restore`` gives every rank the full tensors;
``runtime.elastic.resume_on_mesh`` lays them out on a mesh.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as tree_mod

__all__ = ["Checkpointer"]


def _host_copy(key: str, leaf: torch.Tensor, write: bool) -> Optional[np.ndarray]:
    """The leaf as a numpy array that no later update of the leaf changes
    (a DTensor's global value), or None on a rank that does not write."""
    if leaf.dtype == torch.bfloat16:
        raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy cannot hold; "
                        "checkpoint the fp32 master weights")
    t = leaf.detach()
    if hasattr(t, "full_tensor"):  # every rank takes part in the gather
        t = t.full_tensor()
    if not write:
        return None
    arr = t.cpu().numpy()
    return arr.copy() if t.device.type == "cpu" else arr  # .cpu() copies from the card


def _world() -> Optional[Any]:
    """The process group's module where one is running, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _snapshot(tree: Any):
    world = _world()
    write = world is None or world.get_rank() == 0
    snap = [(key, _host_copy(key, leaf, write)) for key, leaf in
            (("/".join(path), leaf) for path, leaf in tree_mod.items(tree))]
    return snap if write else None


class Checkpointer:
    def __init__(self, directory: Union[str, os.PathLike], *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._pending = False  # an async save whose write the ranks have not waited for

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, metadata: Optional[Dict] = None) -> pathlib.Path:
        self.wait()
        snapshot = _snapshot(tree)
        final = self._path(step)
        if snapshot is not None:
            final = self._write(step, snapshot, metadata or {})
        self._barrier()
        return final

    def save_async(self, step: int, tree: Any, *, metadata: Optional[Dict] = None) -> None:
        self.wait()
        snapshot = _snapshot(tree)  # on the host before this returns
        self._pending = True
        if snapshot is None:
            return

        def _bg():
            self._write(step, snapshot, metadata or {})

        self._thread = threading.Thread(target=_bg, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            self._barrier()

    @staticmethod
    def _barrier() -> None:
        world = _world()
        if world is not None and world.get_world_size() > 1:
            world.barrier()

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}"

    def _write(self, step: int, snapshot, metadata: Dict) -> pathlib.Path:
        final = self._path(step)
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "metadata": metadata, "leaves": []}
        for i, (key, arr) in enumerate(snapshot):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_????????"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = sorted(self.dir.glob("step_????????"))
        if not steps:
            return None
        return int(steps[-1].name.split("_")[1])

    def restore(
        self, tree_like: Any, step: Optional[int] = None, *,
        device: Union[None, str, torch.device] = None,
    ) -> Tuple[Any, Dict]:
        """Restore into the structure of ``tree_like`` (the same leaves, in
        order, with the same shapes) as tensors, each on the device of its
        template leaf, or on ``device`` where given: full tensors on every
        rank, whatever the template's layout. Returns (tree, metadata)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = tree_mod.leaves(tree_like)
        if len(flat) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, expected {len(flat)}"
            )
        out = []
        for like, leaf in zip(flat, manifest["leaves"]):
            arr = np.load(d / leaf["file"])
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"leaf {leaf['key']!r}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(like.shape)}")
            out.append(torch.from_numpy(arr).to(like.device if device is None else device))
        return tree_mod.unflatten(tree_like, out), manifest["metadata"]
