"""Multi-level computation reuse (paper §II-B).

Two granularities:

* **Stage-level (coarse)** — stage instances whose *entire* parameter set (as
  consumed by the stage) is identical are executed once
  (:func:`stage_level_dedup`).

* **Task-level (fine)** — instances with overlapping-but-unequal parameters
  are merged: a **reuse tree** (trie) is built whose level *d* is keyed by
  the parameter values consumed by task *d* of the stage pipeline. Two
  instances share the computation of tasks 0..d iff they lie on the same
  trie path down to depth d. The number of trie nodes == number of task
  executions after perfect merging.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.workflow import StageInstance, StageSpec, task_key

__all__ = [
    "ReuseNode",
    "ReuseTree",
    "stage_level_dedup",
    "build_reuse_tree",
    "reuse_stats",
]


@dataclasses.dataclass
class ReuseNode:
    """One merged task execution.

    ``key``     — (task param values) trie key at this level,
    ``depth``   — task index in the stage pipeline (root has depth -1),
    ``children``— next-task nodes keyed by their task key,
    ``instances`` — stage instances whose path passes through this node.
    """

    key: Tuple[Any, ...]
    depth: int
    parent: Optional["ReuseNode"] = None
    children: Dict[Tuple[Any, ...], "ReuseNode"] = dataclasses.field(default_factory=dict)
    instances: List[StageInstance] = dataclasses.field(default_factory=list)
    uid: int = -1

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def path(self) -> List["ReuseNode"]:
        node, out = self, []
        while node is not None and node.depth >= 0:
            out.append(node)
            node = node.parent
        return out[::-1]


@dataclasses.dataclass
class ReuseTree:
    """Trie over the per-task parameter values of a set of stage instances."""

    stage: StageSpec
    root: ReuseNode
    n_instances: int
    _uid: int = 0

    def nodes(self) -> List[ReuseNode]:
        out: List[ReuseNode] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.depth >= 0:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def leaves(self) -> List[ReuseNode]:
        return [n for n in self.nodes() if n.is_leaf]

    def unique_task_count(self) -> int:
        return len(self.nodes())


def stage_level_dedup(
    instances: Sequence[StageInstance],
) -> Tuple[List[StageInstance], Dict[int, int]]:
    """Coarse-grain reuse: one representative per distinct consumed-parameter
    signature. Returns (representatives, run_id -> representative index)."""
    reps: List[StageInstance] = []
    sig_to_rep: Dict[Tuple[Any, ...], int] = {}
    mapping: Dict[int, int] = {}
    for inst in instances:
        sig = inst.task_keys()
        if sig not in sig_to_rep:
            sig_to_rep[sig] = len(reps)
            reps.append(inst)
        mapping[inst.run_id] = sig_to_rep[sig]
    return reps, mapping


def build_reuse_tree(
    stage: StageSpec, instances: Sequence[StageInstance]
) -> ReuseTree:
    """Insert every instance as a root→leaf path; shared prefixes share nodes."""
    root = ReuseNode(key=(), depth=-1)
    tree = ReuseTree(stage=stage, root=root, n_instances=len(instances))
    for inst in instances:
        node = root
        for d, task in enumerate(stage.tasks):
            k = task_key(task, inst.params)
            child = node.children.get(k)
            if child is None:
                child = ReuseNode(key=k, depth=d, parent=node, uid=tree._uid)
                tree._uid += 1
                node.children[k] = child
            child.instances.append(inst)
            node = child
    return tree


def reuse_stats(
    stage: StageSpec, instances: Sequence[StageInstance]
) -> Dict[str, float]:
    """Reuse accounting for a perfectly-merged stage family (upper bound on
    what any bucketing can attain). ``reuse_fraction`` matches the paper's
    Table II "Reuse" column: fraction of task executions eliminated."""
    tree = build_reuse_tree(stage, instances)
    total = len(instances) * len(stage.tasks)
    unique = tree.unique_task_count()
    return {
        "total_tasks": float(total),
        "unique_tasks": float(unique),
        "reuse_fraction": 1.0 - unique / total if total else 0.0,
    }
