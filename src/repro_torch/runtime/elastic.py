"""Elastic scaling: resume a run on a smaller (or larger) mesh, the JAX
package's ``repro.runtime.elastic``.

Checkpoints are mesh-agnostic (full tensors and a manifest;
``repro_torch.checkpoint``), and every layout in ``repro_torch.dist`` is a
function of the mesh, so after losing half the ranks the survivors:

  1. form a new, smaller world, as an elastic restart under ``torchrun``
     does (a ``DeviceMesh`` over a subset of a live world would need every
     rank's ``new_group`` call, the lost ones' too), and build a mesh over
     it (``launch.mesh.make_mesh_from_devices``);
  2. re-derive the parameter and optimizer layouts for the new mesh
     (``param_shardings``);
  3. restore the checkpoint and lay it out on the new mesh (:func:`reshard_tree`);
  4. resume the step function, which takes its layouts from its inputs.

``reshard_tree`` is the core primitive; it also serves scale-up (ranks
join) and mesh-shape changes.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch import tree as tree_mod
from repro_torch.dist.sharding import distribute, make_ctx, param_shardings

__all__ = ["reshard_tree", "resume_on_mesh"]


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Every leaf laid out by its ``NamedSharding`` (``distribute_tensor``
    of a full tensor, ``redistribute`` of a DTensor on the same mesh);
    ``None`` leaves it as it is."""
    if shardings is None:
        return tree
    return tree_mod.tree_map(lambda x, s: x if s is None else distribute(x, s), tree, shardings)


def resume_on_mesh(checkpointer, template: Any, mesh, *, mode: str = "train",
                   step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore the latest checkpoint (or ``step``) and lay it out on ``mesh``."""
    restored, meta = checkpointer.restore(template, step=step)
    ctx = make_ctx(mesh, mode=mode)
    return reshard_tree(restored, param_shardings(restored, ctx)), meta
