"""plan_study — the planning half of the unified StudyPlanner engine.

One pipeline for every SA workload (DESIGN.md §3/§4):

  1. **group**    — stage-*k* instances are partitioned by their *upstream
                    signature* (the concatenated task keys of stages < k).
                    Two runs share a group iff every upstream task they
                    consumed agrees, i.e. iff they receive bit-identical
                    stage inputs — the precondition for merging them. A
                    parameter-free stage yields a single group containing a
                    single-path trie, so it collapses to one shared
                    execution automatically.
  2. **bucket**   — a pluggable policy splits each group into merge units:
                    ``"rtma"``   paper baseline, buckets capped by
                                 ``max_bucket_for_budget`` (breadth-eligible
                                 execution, width-proportional memory);
                    ``"rmsr"``   one maximal bucket, ``active_paths`` solved
                                 against the budget (depth-first execution);
                    ``"hybrid"`` RTMA-sized buckets each scheduled by RMSR —
                                 the paper's Fig 6/7 matrix as one API;
                    ``"stage"``  coarse-grain dedup only;
                    ``"none"``   the no-reuse baseline.
  3. **schedule** — every bucket's reuse tree is traversed ahead-of-time
                    (``simulate_execution``) to freeze the execution order
                    and prove its peak live bytes.

The resulting :class:`StudyPlan` is input-independent: plan once, execute on
many inputs (tiles, prompt batches) via ``execute_plan``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.params import ParamSet
from repro_torch.core.reuse import build_reuse_tree
from repro_torch.core.rmsr import min_active_paths, simulate_execution, tree_peak_bytes
from repro_torch.core.rtma import max_bucket_for_budget, rtma_buckets
from repro_torch.core.workflow import StageInstance, StageSpec, Workflow
from repro_torch.engine.types import (
    DEFAULT_MAX_BUCKET,
    POLICIES,
    BucketPlan,
    ClusterSpec,
    MemoryBudget,
    StagePlan,
    StudyPlan,
)

__all__ = ["TrieLedger", "plan_study"]

_ALL_ELIGIBLE = 10**9  # "unbounded workers": RTMA's whole frontier is live


class TrieLedger:
    """Cross-round record of planned trie paths — the "cached trie" an
    adaptive study plans its delta against (DESIGN.md §11).

    Members are the deterministic ``repr`` of the executor's input-agnostic
    cache keys (``bucket.cache_scope + (trie-path,)``), so ledger membership
    means exactly: *a prior plan scheduled this merged task, and the
    persistent result store holds (or held) its output*. ``plan_study``
    consults the ledger to annotate each bucket's ``known_nodes`` — the
    plan-time prediction of which merged tasks the store will serve — and
    records the rest, making the next round's plan incremental too.

    The ledger is a plain string set, so it serialises into a StudyState
    checkpoint losslessly (``to_list``/``from_list``).
    """

    def __init__(self, entries: Optional[Iterable[str]] = None):
        self._seen: Set[str] = set(entries or ())

    def __len__(self) -> int:
        return len(self._seen)

    def __contains__(self, key: Tuple) -> bool:
        return repr(key) in self._seen

    def add_all(self, keys: Iterable[Tuple]) -> None:
        self._seen.update(repr(k) for k in keys)

    def merge(self, entries: Iterable[str]) -> None:
        """Union already-serialised entries (``to_list`` output from another
        process's ledger) into this one — the fleet-merge path: round N+1
        plans against the union of every process's committed keys."""
        self._seen.update(entries)

    def to_list(self) -> List[str]:
        return sorted(self._seen)

    @classmethod
    def from_list(cls, entries: Iterable[str]) -> "TrieLedger":
        return cls(entries)


def _annotate_with_ledger(
    stage_plans: List[StagePlan], ledger: TrieLedger
) -> List[Tuple]:
    """Mark each bucket's trie nodes as known/new against the ledger.

    Knownness is assessed against the ledger *at entry* (prior rounds), not
    against siblings of this plan — intra-plan duplicate prefixes are the
    run-level cache's business and are already visible in the measured
    hit counters. Returns the plan's NEW keys; the caller commits them to
    the ledger only once the plan has actually executed (ledger membership
    means "the store holds, or held, this output" — a plan that fails
    mid-execution must not poison the next round's accounting).
    """
    new_keys: List[Tuple] = []
    for sp in stage_plans:
        for bucket in sp.buckets:
            known = 0
            stack: List[Tuple[Any, Tuple]] = [
                (child, ()) for child in bucket.tree.root.children.values()
            ]
            while stack:
                node, prefix = stack.pop()
                pk = prefix + (node.key,)
                full = bucket.cache_scope + (pk,)
                if full in ledger:
                    known += 1
                else:
                    new_keys.append(full)
                stack.extend((c, pk) for c in node.children.values())
            bucket.known_nodes = known
    return new_keys


def _rtma_bucket_size(
    stage: StageSpec,
    instances: Sequence[StageInstance],
    memory: MemoryBudget,
    max_bucket_size: Optional[int],
) -> int:
    if max_bucket_size is not None:
        return max(1, max_bucket_size)
    if memory.schedule_bytes is not None:
        return max_bucket_for_budget(
            stage, instances, memory.schedule_bytes, tree_peak_bytes
        )
    return DEFAULT_MAX_BUCKET


def _by_signature(
    instances: Sequence[StageInstance],
) -> Dict[Any, List[StageInstance]]:
    """Stage-level dedup grouping: one entry per distinct full task-key
    signature (the same equivalence ``reuse.stage_level_dedup`` uses)."""
    by_sig: Dict[Any, List[StageInstance]] = {}
    for inst in instances:
        by_sig.setdefault(inst.task_keys(), []).append(inst)
    return by_sig


def _plan_group(
    stage_index: int,
    stage: StageSpec,
    group_key: Any,
    instances: List[StageInstance],
    policy: str,
    memory: MemoryBudget,
    max_bucket_size: Optional[int],
    active_paths: Optional[int],
    workers: Optional[int],
) -> List[BucketPlan]:
    if policy == "none":
        parts: List[List[StageInstance]] = [[i] for i in instances]
    elif policy == "stage":
        by_sig = _by_signature(instances)
        parts = [by_sig[k] for k in sorted(by_sig, key=repr)]
    elif policy == "rmsr":
        parts = [list(instances)]
    else:  # rtma | hybrid
        # stage-level dedup first: bucket one representative per distinct
        # signature, then re-attach the duplicates to their representative's
        # bucket (same trie path, so the node count is unchanged and every
        # run_id still routes).
        by_sig = _by_signature(instances)
        reps = [group[0] for group in by_sig.values()]
        bsize = _rtma_bucket_size(stage, reps, memory, max_bucket_size)
        parts = [
            [inst for rep in bk.instances for inst in by_sig[rep.task_keys()]]
            for bk in rtma_buckets(stage, reps, bsize)
        ]

    out: List[BucketPlan] = []
    depth_first = policy in ("rmsr", "hybrid")
    for part in parts:
        tree = build_reuse_tree(stage, part)
        if depth_first:
            paths = active_paths
            if paths is None:
                if memory.schedule_bytes is not None:
                    paths = min_active_paths(tree, memory.schedule_bytes) or 1
                else:
                    paths = 1
            sched = simulate_execution(tree, paths, discipline="lifo")
            disc = "lifo"
        else:
            paths = workers if workers is not None else _ALL_ELIGIBLE
            sched = simulate_execution(tree, paths, discipline="fifo")
            disc = "fifo"
        out.append(
            BucketPlan(
                stage_index=stage_index,
                stage_name=stage.name,
                group_key=group_key,
                instances=part,
                tree=tree,
                schedule=sched,
                active_paths=paths,
                discipline=disc,
            )
        )
    return out


def plan_study(
    workflow: Workflow,
    param_sets: Sequence[ParamSet],
    *,
    memory: Optional[MemoryBudget] = None,
    cluster: Optional[ClusterSpec] = None,
    policy: str = "hybrid",
    max_bucket_size: Optional[int] = None,
    active_paths: Optional[int] = None,
    workers: Optional[int] = None,
    ledger: Optional[TrieLedger] = None,
) -> StudyPlan:
    """Plan an SA study: stage-level dedup, per-stage reuse trees, pluggable
    bucketing, AOT schedules with exact peak-bytes, and multi-stage routing.

    ``workers`` only parameterises the breadth-eligible (RTMA) makespan
    model; ``active_paths`` overrides the budget-solved RMSR bound.

    **Incremental path** (adaptive multi-round studies, DESIGN.md §11):
    passing a :class:`TrieLedger` makes the plan *delta-aware*. Callers
    (``repro_torch.study.StudyDriver``) first drop ParamSets whose outputs prior
    rounds already produced, so ``param_sets`` is the round's delta
    run-list; the ledger then annotates every bucket with ``known_nodes`` —
    trie paths a prior round planned, whose outputs the persistent result
    store will serve as cache hits — and ``plan.tasks_new`` is the true
    marginal work of this round. The plan's not-yet-known keys are staged
    on ``plan.ledger_pending``; callers commit them with
    ``ledger.add_all(plan.ledger_pending)`` after the plan executes
    successfully, so a failed round never records phantom results.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")
    memory = memory or MemoryBudget()
    param_sets = list(param_sets)
    by_stage = workflow.instantiate(param_sets)

    # Upstream signature per run: grows one element per planned stage; runs
    # with equal signatures provably receive identical stage inputs.
    upstream: Dict[int, tuple] = {rid: () for rid in range(len(param_sets))}
    stage_plans: List[StagePlan] = []
    for si, stage in enumerate(workflow.stages):
        instances = by_stage[stage.name]
        groups: Dict[tuple, List[StageInstance]] = {}
        for inst in instances:
            groups.setdefault(upstream[inst.run_id], []).append(inst)
        buckets: List[BucketPlan] = []
        for gkey in sorted(groups, key=repr):
            buckets.extend(
                _plan_group(
                    si, stage, gkey, groups[gkey], policy, memory,
                    max_bucket_size, active_paths, workers,
                )
            )
        stage_plans.append(
            StagePlan(
                stage=stage,
                index=si,
                buckets=buckets,
                tasks_total=len(instances) * len(stage.tasks),
            )
        )
        for inst in instances:
            upstream[inst.run_id] = upstream[inst.run_id] + (inst.task_keys(),)

    ledger_pending = (
        _annotate_with_ledger(stage_plans, ledger) if ledger is not None else None
    )

    return StudyPlan(
        workflow=workflow,
        n_runs=len(param_sets),
        policy=policy,
        stages=stage_plans,
        memory=memory,
        cluster=cluster,
        ledger_pending=ledger_pending,
        # Everything needed to rebuild this plan against the same workflow
        # in another process (planning is deterministic; the ledger only
        # annotates counters, so it is deliberately absent). All values are
        # picklable — ParamSets are tuples of (name, primitive).
        recipe={
            "param_sets": [tuple(ps) for ps in param_sets],
            "policy": policy,
            "max_bucket_size": max_bucket_size,
            "active_paths": active_paths,
            "workers": workers,
            "memory_bytes": memory.bytes,
            "cache_bytes": memory.cache_bytes,
        },
    )
