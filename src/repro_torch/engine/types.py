"""Plan/result datatypes of the unified StudyPlanner engine (DESIGN.md §3).

A :class:`StudyPlan` is the ahead-of-time artifact of ``plan_study``: per
stage, per upstream-input group, a list of :class:`BucketPlan`s, each holding
its merged reuse tree and the exact :class:`~repro_torch.core.rmsr.ScheduleResult`
(execution order + provable peak-bytes) the executor will follow. Because the
schedule is computed at plan time, ``peak_bytes`` is a *proof* about the
execution, not an estimate — the executor replays the order and frees buffers
per the same liveness rule the accounting used.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.reuse import ReuseTree
from repro_torch.core.rmsr import ScheduleResult
from repro_torch.core.workflow import StageInstance, StageSpec, Workflow

__all__ = [
    "MemoryBudget",
    "ClusterSpec",
    "BucketPlan",
    "StagePlan",
    "StudyPlan",
    "StudyResult",
    "StudyStreamResult",
]

POLICIES = ("none", "stage", "rtma", "rmsr", "hybrid")

# Policies whose semantics include task-level (trie) reuse; only these may
# share merged prefixes through the executor's run-level result cache —
# caching under "none"/"stage" would silently upgrade the baselines.
CACHING_POLICIES = ("rtma", "rmsr", "hybrid")

DEFAULT_MAX_BUCKET = 8
DEFAULT_CACHE_BYTES = 128 << 20


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Memory constraints the planner solves against.

    ``bytes``       — per-worker budget for ALL live state: schedule buffers
                      plus the result cache. The planner sizes RTMA buckets
                      (``max_bucket_for_budget``) and RMSR ``active_paths``
                      (``min_active_paths``) against ``schedule_bytes`` =
                      bytes − cache reservation, so schedule peak + cache
                      together stay under ``bytes``.
    ``cache_bytes`` — byte cap of the executor's run-level result cache
                      (0 disables it). Under a finite budget the effective
                      cap is clamped to bytes/8 so the cache can never
                      crowd out the schedule.
    """

    bytes: Optional[int] = None
    cache_bytes: int = DEFAULT_CACHE_BYTES

    @property
    def effective_cache_bytes(self) -> int:
        if self.bytes is None:
            return self.cache_bytes
        return min(self.cache_bytes, self.bytes // 8)

    @property
    def schedule_bytes(self) -> Optional[int]:
        """What the planner may let live buffers reach; the cache retains up
        to ``effective_cache_bytes`` on top, keeping the total under
        ``bytes``."""
        if self.bytes is None:
            return None
        return self.bytes - self.effective_cache_bytes


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """How ``execute_plan`` dispatches buckets through the Manager."""

    n_workers: int = 1
    max_attempts: int = 3
    heartbeat_timeout: float = 60.0
    straggler_factor: float = 3.0
    enable_backup_tasks: bool = True


@dataclasses.dataclass
class BucketPlan:
    """One merged coarse task: a reuse tree plus its frozen schedule."""

    stage_index: int
    stage_name: str
    group_key: Tuple[Any, ...]  # upstream-signature this bucket's input hangs on
    instances: List[StageInstance]
    tree: ReuseTree
    schedule: ScheduleResult
    active_paths: int
    discipline: str  # "lifo" (RMSR depth-first) | "fifo" (RTMA breadth-eligible)
    # Trie nodes of this bucket already recorded in the TrieLedger at plan
    # time (prior-round work the persistent result store will serve as
    # hits); 0 for non-incremental plans.
    known_nodes: int = 0

    @property
    def run_ids(self) -> List[int]:
        return [i.run_id for i in self.instances]

    @property
    def cache_scope(self) -> Tuple[Any, ...]:
        """Cache-key prefix: buckets of the same stage whose instances share
        the same upstream outputs may share merged-prefix results."""
        return (self.stage_index, self.stage_name, self.group_key)


@dataclasses.dataclass
class StagePlan:
    stage: StageSpec
    index: int
    buckets: List[BucketPlan]
    tasks_total: int

    @property
    def tasks_executed(self) -> int:
        return sum(b.tree.unique_task_count() for b in self.buckets)

    @property
    def tasks_known(self) -> int:
        return sum(b.known_nodes for b in self.buckets)

    @property
    def peak_bytes(self) -> int:
        return max((b.schedule.peak_bytes for b in self.buckets), default=0)

    @property
    def work_seconds(self) -> float:
        return sum(b.schedule.total_cost for b in self.buckets)

    @property
    def makespan(self) -> float:
        return sum(b.schedule.makespan for b in self.buckets)


@dataclasses.dataclass
class StudyPlan:
    workflow: Workflow
    n_runs: int
    policy: str
    stages: List[StagePlan]
    memory: MemoryBudget
    cluster: Optional[ClusterSpec] = None
    # Incremental planning (plan_study(..., ledger=...)): cache keys this
    # plan introduces that the TrieLedger did not know. The caller commits
    # them (ledger.add_all) once the plan has executed successfully.
    ledger_pending: Optional[List[Tuple[Any, ...]]] = None
    # The picklable planning arguments this plan was built from (param
    # sets, policy, bucketing knobs, memory budget). Planning is
    # deterministic, so a worker process holding the same Workflow rebuilds
    # a structurally identical plan from the recipe — how a StudyPlan
    # crosses the RPC boundary without serialising task closures
    # (DESIGN.md §13).
    recipe: Optional[Dict[str, Any]] = None

    @property
    def tasks_total(self) -> int:
        return sum(s.tasks_total for s in self.stages)

    @property
    def tasks_executed(self) -> int:
        return sum(s.tasks_executed for s in self.stages)

    @property
    def tasks_known(self) -> int:
        """Merged tasks already in the cross-round TrieLedger at plan time
        (expected to be served by the persistent result store)."""
        return sum(s.tasks_known for s in self.stages)

    @property
    def tasks_new(self) -> int:
        """The incremental-plan delta: merged tasks this plan introduces on
        top of what prior rounds already computed."""
        return self.tasks_executed - self.tasks_known

    @property
    def reuse_fraction(self) -> float:
        total = self.tasks_total
        return 1.0 - self.tasks_executed / total if total else 0.0

    @property
    def peak_bytes(self) -> int:
        """Peak live bytes of any single in-flight bucket — the per-worker
        guarantee. With W concurrent workers the node-level peak is bounded
        by the sum of the W largest bucket peaks."""
        return max((s.peak_bytes for s in self.stages), default=0)

    @property
    def active_paths(self) -> int:
        return max((b.active_paths for s in self.stages for b in s.buckets), default=1)

    @property
    def work_seconds(self) -> float:
        return sum(s.work_seconds for s in self.stages)

    @property
    def makespan(self) -> float:
        """Single-worker serial makespan model (buckets back-to-back); the
        cluster-level model lives in runtime.simulator."""
        return sum(s.makespan for s in self.stages)

    @property
    def cache_enabled(self) -> bool:
        return self.policy in CACHING_POLICIES and self.memory.effective_cache_bytes > 0

    def bucket_count(self) -> int:
        return sum(len(s.buckets) for s in self.stages)


@dataclasses.dataclass
class StudyResult:
    """Outputs of ``execute_plan``: final-stage state per run, plus the
    actual execution accounting (may differ from the plan's when the result
    cache absorbs retries/backup tasks or cross-bucket shared prefixes)."""

    outputs: Dict[int, Any]
    tasks_executed: int
    cache_hits: int
    retries: int
    backups_launched: int
    wall_seconds: float
    per_stage_executed: List[int] = dataclasses.field(default_factory=list)
    # run-level ResultCache deltas for this execution (0 when caching is
    # disabled): misses, spill-tier writes, and store rehydrations.
    cache_misses: int = 0
    cache_spills: int = 0
    cache_rehydrations: int = 0
    # which WorkerBackend dispatched this execution, and how many leases it
    # was handed (this call's delta of Manager.dispatch_counts)
    backend: str = "thread"
    dispatch_counts: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StudyStreamResult:
    """Outputs of ``execute_study``: one study-wide streaming execution of a
    plan over many inputs through a single persistent Manager session
    (DESIGN.md §10).

    ``outputs[i][run_id]`` is the final-stage state of run ``run_id`` on
    input ``i`` — bit-identical to ``execute_plan(plan, inputs[i])``.
    ``per_input`` carries the per-input accounting (task counts, cache hits,
    per-stage executed, submit→complete latency); ``retries`` /
    ``backups_launched`` are session-wide because the persistent Manager
    spans all inputs. ``busy_seconds`` sums the winning attempts' wall-times,
    so ``parallel_efficiency`` matches the paper's busy/(makespan×workers)
    definition.
    """

    outputs: Dict[int, Dict[int, Any]]
    per_input: List[StudyResult]
    n_inputs: int
    n_workers: int
    tasks_executed: int
    cache_hits: int
    retries: int
    backups_launched: int
    wall_seconds: float
    busy_seconds: float
    manager_sessions: int = 1
    # run-level ResultCache deltas for this study (0 when caching is
    # disabled); with an external round-persistent cache these are THIS
    # call's contribution, not the cache's lifetime totals.
    cache_misses: int = 0
    cache_spills: int = 0
    cache_rehydrations: int = 0
    # which WorkerBackend the session dispatched through, and the leases it
    # was handed during this study (delta of Manager.dispatch_counts)
    backend: str = "thread"
    dispatch_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Manager.scheduler_stats() snapshot at study end: hierarchy mode and
    # fanout, steal/locality counters, pump occupancy, per-worker busy
    # seconds and mean idle fraction (DESIGN.md §15)
    scheduler: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def throughput(self) -> float:
        """Completed inputs per second of study wall-clock."""
        from repro_torch.core.metrics import throughput

        return throughput(self.n_inputs, self.wall_seconds)

    @property
    def parallel_efficiency(self) -> float:
        from repro_torch.core.metrics import parallel_efficiency

        return parallel_efficiency(
            self.busy_seconds, self.wall_seconds, self.n_workers
        )
