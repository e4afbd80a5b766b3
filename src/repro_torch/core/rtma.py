"""RTMA — Reuse-Tree Merging Algorithm (paper §II-B, Fig 4; baseline from
Barreiros et al., CLUSTER 2017).

RTMA groups stage instances into *buckets* of at most ``MaxBucketSize``; the
instances of a bucket are merged into one coarser stage whose internal task
tree realises the reuse. Because RTMA executes the merged tree with all
branches eligible concurrently, its peak memory grows with the tree *width*
(∝ bucket size), so ``MaxBucketSize`` must be capped to the machine memory —
the limitation RMSR removes.

Bucketing (Fig 4), faithful to the paper:
  1. **prune** — repeatedly, instances whose attach nodes share a parent and
     that suffice to fill a bucket (``MaxBucketSize`` of them, deepest parents
     first so the most-sharing groups are bucketed together) are emitted as a
     bucket and removed.
  2. **move-up** — every remaining instance's attach node moves one level up
     (childless interior nodes conceptually pruned).
  3. Repeat until all instances are assigned; at the root, leftovers form a
     final (possibly under-full) bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.reuse import ReuseNode, ReuseTree, build_reuse_tree
from repro_torch.core.workflow import StageInstance, StageSpec

__all__ = ["Bucket", "rtma_buckets", "bucket_reuse_stats", "max_bucket_for_budget"]


@dataclasses.dataclass
class Bucket:
    """A set of stage instances merged into one coarse stage instance."""

    instances: List[StageInstance]

    def tree(self, stage: StageSpec) -> ReuseTree:
        return build_reuse_tree(stage, self.instances)


def rtma_buckets(
    stage: StageSpec,
    instances: Sequence[StageInstance],
    max_bucket_size: int,
) -> List[Bucket]:
    if max_bucket_size < 1:
        raise ValueError("max_bucket_size must be >= 1")
    tree = build_reuse_tree(stage, instances)

    # Attach each instance at its full-depth leaf node.
    attach: Dict[int, ReuseNode] = {}
    by_run: Dict[int, StageInstance] = {}
    for leaf in tree.leaves():
        for inst in leaf.instances:
            if inst.run_id in attach:
                continue
            attach[inst.run_id] = leaf
            by_run[inst.run_id] = inst

    pending = sorted(attach.keys())
    buckets: List[Bucket] = []

    while pending:
        # --- prune phase: group by parent of attach node, deepest first ---
        groups: Dict[int, List[int]] = {}
        parent_of: Dict[int, Optional[ReuseNode]] = {}
        for rid in pending:
            p = attach[rid].parent
            key = id(p) if p is not None else -1
            groups.setdefault(key, []).append(rid)
            parent_of[key] = p

        emitted = False
        order = sorted(
            groups.items(),
            key=lambda kv: -(parent_of[kv[0]].depth if parent_of[kv[0]] else -1),
        )
        assigned: set = set()
        for key, rids in order:
            rids = [r for r in rids if r not in assigned]
            while len(rids) >= max_bucket_size:
                take, rids = rids[:max_bucket_size], rids[max_bucket_size:]
                buckets.append(Bucket([by_run[r] for r in take]))
                assigned.update(take)
                emitted = True
        pending = [r for r in pending if r not in assigned]
        if not pending:
            break

        # --- move-up phase (or final partial bucket at the root) ---
        at_root = all(attach[r] is tree.root for r in pending)
        if at_root:
            if not emitted:
                for i in range(0, len(pending), max_bucket_size):
                    take = pending[i : i + max_bucket_size]
                    buckets.append(Bucket([by_run[r] for r in take]))
                pending = []
            continue
        for rid in pending:
            node = attach[rid]
            if node is not tree.root and node.parent is not None:
                attach[rid] = node.parent
    return buckets


def bucket_reuse_stats(stage: StageSpec, buckets: Sequence[Bucket]) -> Dict[str, float]:
    """Task-reuse attained by a bucketing: tasks executed = Σ unique trie
    nodes per bucket (reuse never crosses buckets — the paper's limitation)."""
    total = sum(len(b.instances) for b in buckets) * len(stage.tasks)
    unique = sum(b.tree(stage).unique_task_count() for b in buckets)
    return {
        "total_tasks": float(total),
        "unique_tasks": float(unique),
        "reuse_fraction": 1.0 - unique / total if total else 0.0,
    }


def max_bucket_for_budget(
    stage: StageSpec,
    instances: Sequence[StageInstance],
    budget_bytes: int,
    peak_bytes_fn,
) -> int:
    """Largest MaxBucketSize whose *worst bucket* peak memory (under RTMA's
    breadth-eligible execution, computed by ``peak_bytes_fn(tree)``) fits the
    budget. This is how the paper sizes RTMA per machine (Table II)."""
    best = 1
    for b in range(2, len(instances) + 1):
        buckets = rtma_buckets(stage, instances, b)
        worst = max(peak_bytes_fn(bk.tree(stage)) for bk in buckets)
        if worst <= budget_bytes:
            best = b
        else:
            break
    return best
