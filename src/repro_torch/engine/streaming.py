"""execute_study — the dataset-level streaming executor (DESIGN.md §10).

The paper's headline numbers come from SA over *datasets*: hundreds of
whole-slide tiles flowing through the Manager-Worker runtime at >92%
parallel efficiency. A :class:`~repro_torch.engine.types.StudyPlan` is
input-independent ("plan once, execute on every tile"), so the dataset
dimension is pure execution: ``execute_study(plan, inputs)`` drives many
inputs through one plan concurrently inside a **single persistent Manager
session** spanning every input and stage.

The global per-stage barrier of the one-input executor becomes a
**per-input dependency edge**: stage *s+1* buckets of input *i* are
submitted the moment the last stage-*s* bucket of input *i* completes (a
Manager completion callback), so tile A can be in segmentation while tile B
is still normalizing and Workers never idle at a stage boundary waiting for
an unrelated tile. Parameter-free stages still collapse to one shared
execution *per input* (that is a plan property), and the run-level
:class:`~repro_torch.engine.executor.ResultCache` is keyed with an input-scoped
segment so cross-input collisions are structurally impossible — tasks are
pure functions of ``(input, params)`` and the input differs.

``execute_plan`` is the K=1 special case and delegates here, which is what
makes the differential guarantee cheap to state: ``execute_study`` over K
inputs is bit-identical to K sequential ``execute_plan`` calls under every
policy and worker count, while starting one Manager session instead of K.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, List, Optional, Sequence

from repro_torch import trace
from repro_torch.engine.executor import ResultCache, execute_bucket
from repro_torch.engine.types import (
    ClusterSpec,
    StudyPlan,
    StudyResult,
    StudyStreamResult,
)
from repro_torch.runtime.manager import Manager, TaskCancelled, WorkItem

__all__ = ["execute_study", "study_task_keys"]


def study_task_keys(
    plan: "StudyPlan", n_inputs: int, key_prefix: str = ""
) -> List[str]:
    """The complete, deterministic list of WorkItem keys ``execute_study``
    will submit for ``plan`` over ``n_inputs`` inputs. The service registry
    precomputes these for admission control (task quotas), per-job
    refcounting and cancellation — no callback channel from the executor
    is needed, because keys are a pure function of (plan, input index)."""
    keys: List[str] = []
    for i in range(n_inputs):
        for sp in plan.stages:
            for bi in range(len(sp.buckets)):
                keys.append(
                    f"{key_prefix}in{i}:{sp.index}:{sp.stage.name}:{bi}"
                )
    return keys

# Unique plan ids for spec-capable backends: an external Manager session
# may execute many plans (adaptive rounds), and worker processes cache the
# rebuilt plans by this id.
_PLAN_IDS = itertools.count()  # guard: _PLAN_IDS_LOCK
_PLAN_IDS_LOCK = threading.Lock()


class _InputState:
    """Mutable per-input progress record; guarded by the study lock."""

    __slots__ = (
        "current", "routed", "remaining", "executed", "hits",
        "t_submit", "t_done",
    )

    def __init__(self, plan: StudyPlan, input_state: Any):
        self.current = {rid: input_state for rid in range(plan.n_runs)}
        self.routed: dict = {}
        self.remaining = [len(sp.buckets) for sp in plan.stages]
        self.executed = [0] * len(plan.stages)
        self.hits = [0] * len(plan.stages)
        self.t_submit = 0.0
        self.t_done = 0.0


def execute_study(
    plan: StudyPlan,
    inputs: Sequence[Any],
    *,
    cluster: Optional[ClusterSpec] = None,
    cache: Optional[ResultCache] = None,
    manager: Optional[Manager] = None,
    backend: Any = None,
    hierarchy: Any = None,
    input_keys: Optional[Sequence[Any]] = None,
    key_prefix: str = "",
    shared: bool = False,
    tenant: str = "",
    priority: int = 0,
    cancel_event: Optional[threading.Event] = None,
    on_progress: Optional[Any] = None,
) -> StudyStreamResult:
    """Execute a :class:`StudyPlan` on every input in ``inputs``, pipelined
    through one persistent Manager session.

    Outputs are bit-identical to sequential per-input execution: buckets
    replay frozen schedules of pure tasks, routing is keyed by ``run_id``
    alone, and the result cache carries an input-scoped key segment. The
    first permanently-failed bucket (Manager retries exhausted) aborts the
    study after the session drains, re-raising the original exception.

    Multi-round (adaptive-study) extensions, all default-off:

    * ``cache``     — an external, round-persistent :class:`ResultCache`
      (optionally spill-store-backed). Honoured only when the plan's policy
      admits caching (``plan.cache_enabled``), so the ``none``/``stage``
      baselines stay honest. Without it a fresh per-study cache is built.
    * ``manager``   — an external, already-``start``-ed Manager session to
      submit into; the session is drained but left running for the next
      round. Accounting (retries, backups, busy seconds) reports this
      call's delta, and ``manager_sessions`` is 0 (no session started
      here).
    * ``input_keys``— stable per-input identities for the cache's input
      scope segment (default: the positional index). Required for
      cross-round reuse: round *N*'s "tile «a»" must key identically to
      round 1's.
    * ``key_prefix``— disambiguates WorkItem keys inside a shared session
      (the Manager memoises results by key, so two rounds submitting
      ``in0:…`` verbatim would collide).

    ``backend`` selects the session's WorkerBackend (default: in-process
    Worker threads; mutually exclusive with ``manager``, whose own backend
    is used). ``hierarchy`` selects the session's scheduler topology
    (DESIGN.md §15): ``None``/"flat" keeps the single-pump Manager,
    ``"fanout=N"`` (or an int, ``"auto"``, or a
    :class:`~repro_torch.runtime.hierarchy.HierarchySpec`) splits dispatch
    across N sub-manager pumps with locality-aware routing and work
    stealing — outputs stay bit-identical, only placement changes; also
    mutually exclusive with ``manager``. The session's scheduler counters
    (pump occupancy, steals, locality hit-rate) are returned in
    ``StudyStreamResult.scheduler``. With a **spec-capable** backend (``ProcessRpcBackend``) the
    executor ships no closures: it broadcasts the plan's ``recipe`` (the
    picklable planning arguments — workers rebuild the plan against their
    own ``build()`` context) and each WorkItem carries a ``("bucket",
    plan_id, input, stage, bucket)`` spec. Workers resolve stage inputs
    from the shared store by deterministic result keys and commit outputs
    back the same way, so only store keys ever cross the process boundary.

    **Service mode** (DESIGN.md §18), all default-off:

    * ``shared``      — submit WorkItems as content-addressed shared work:
      a key another concurrent study already has pending subscribes this
      study's callback instead of executing twice, and a settled key is
      served from the Manager memo. Requires a ``key_prefix`` derived from
      task CONTENT (the service hashes the study recipe) so identical keys
      always denote identical pure work. In shared mode the study waits on
      its own completion event instead of ``mgr.drain()`` (other tenants'
      work may still be pending in the session) and does NOT ``forget``
      its keys — the owner (the service registry) releases them when no
      live job references them.
    * ``tenant`` / ``priority`` — fair-share class and within-tenant
      dispatch priority stamped on every WorkItem (Manager DRR dispatch).
    * ``cancel_event`` — when set, no further stages are submitted and
      the study raises :class:`TaskCancelled`; the owner is responsible
      for revoking in-flight keys via ``mgr.cancel`` (only those no other
      job references).
    * ``on_progress`` — ``on_progress(done, total)`` called after every
      settled bucket (Manager pump thread; must be cheap and non-raising).
    """
    cluster = cluster or plan.cluster or ClusterSpec()
    inputs = list(inputs)
    if input_keys is None:
        input_keys = list(range(len(inputs)))
    else:
        input_keys = list(input_keys)
        if len(input_keys) != len(inputs):
            raise ValueError("input_keys must align 1:1 with inputs")
    if not plan.cache_enabled:
        cache = None
    elif cache is None:
        cache = ResultCache(plan.memory.effective_cache_bytes)
    if manager is None:
        owns_manager = True
        mgr = Manager(
            backend=backend,
            max_attempts=cluster.max_attempts,
            heartbeat_timeout=cluster.heartbeat_timeout,
            straggler_factor=cluster.straggler_factor,
            enable_backup_tasks=cluster.enable_backup_tasks,
            hierarchy=hierarchy,
        )
    else:
        owns_manager = False
        mgr = manager
        if backend is not None:
            raise ValueError(
                "pass backend= when the executor owns the session; an "
                "external Manager already carries its own backend"
            )
        if hierarchy is not None:
            raise ValueError(
                "pass hierarchy= when the executor owns the session; an "
                "external Manager already carries its own hierarchy"
            )
        if not mgr.is_running:
            raise RuntimeError("external Manager session must be started")
    spec_mode = bool(getattr(mgr.backend, "supports_specs", False))
    plan_id: Optional[str] = None
    if spec_mode and plan.recipe is None:
        raise ValueError(
            "this StudyPlan carries no recipe; re-plan with plan_study() to "
            "execute it on a spec-capable (process) backend"
        )
    retries0, backups0, busy0 = mgr.retries, mgr.backups_launched, mgr.busy_seconds
    dispatch0 = dict(mgr.dispatch_counts)
    cache0 = (
        (cache.misses, cache.spills, cache.rehydrations)
        if cache is not None
        else (0, 0, 0)
    )
    states = [_InputState(plan, inp) for inp in inputs]
    errors: List[BaseException] = []
    lock = threading.Lock()
    n_stages = len(plan.stages)
    total_tasks = sum(len(sp.buckets) for sp in plan.stages) * len(inputs)

    # the caller's span, the parent of every bucket of this study (the
    # pump thread's callbacks submit the later stages)
    parent_span = trace.current()
    submitted: List[str] = []  # list.append is atomic; drained before reads
    # Shared-mode completion accounting (guarded by ``lock``): submitted-
    # but-unsettled keys, settled count, and whether the initial per-input
    # seeding loop is still running (so a tiny study finishing its first
    # input before the second is seeded cannot signal done prematurely).
    outstanding = [0]
    done_tasks = [0]
    seeding = [True]
    done_event = threading.Event()

    def submit_stage(i: int, si: int) -> None:
        if cancel_event is not None and cancel_event.is_set():
            return
        stage_plan = plan.stages[si]
        st = states[i]
        for bi, bucket in enumerate(stage_plan.buckets):
            src = st.current[bucket.run_ids[0]]
            key = f"{key_prefix}in{i}:{stage_plan.index}:{stage_plan.stage.name}:{bi}"
            submitted.append(key)
            with lock:
                outstanding[0] += 1
            # a shared submit of an already-settled key fires the callback
            # synchronously on THIS thread — the lock is not held here
            mgr.submit(
                WorkItem(
                    key=key,
                    fn=lambda b=bucket, s=src, k=input_keys[i]: execute_bucket(
                        b, s, cache, scope=("input", k) + b.cache_scope
                    ),
                    # spec-capable backends ship this instead of the
                    # closure; workers hold the same plan (rebuilt from the
                    # recipe) and resolve src from the shared store
                    spec=("bucket", plan_id, i, si, bi) if spec_mode else None,
                    # reuse-tree prefix for locality-aware hierarchical
                    # dispatch: input first (stage s+1 chases stage s's
                    # worker), then the bucket's trie scope
                    path=(f"{key_prefix}{input_keys[i]}",) + bucket.cache_scope,
                    callback=lambda _key, value, i=i, si=si: on_bucket(i, si, value),
                    shared=shared,
                    tenant=tenant,
                    priority=priority,
                    parent_span=parent_span,
                )
            )

    def on_bucket(i: int, si: int, value: Any) -> None:
        """Per-item completion callback (Manager pump thread, outside the
        Manager lock): fold the bucket into input i's stage accumulator;
        when the stage closes, route outputs and submit the next stage —
        the per-input dependency edge."""
        st = states[i]
        advance = False
        with lock:
            st.remaining[si] -= 1
            if isinstance(value, Exception):
                errors.append(value)
            else:
                bucket_results, executed, hits = value
                st.executed[si] += executed
                st.hits[si] += hits
                st.routed.update(bucket_results)
                if st.remaining[si] == 0:
                    missing = set(range(plan.n_runs)) - set(st.routed)
                    if missing:
                        errors.append(
                            RuntimeError(
                                f"input {i}: stage {plan.stages[si].stage.name!r} "
                                f"produced no output for {len(missing)} runs "
                                f"(first: {sorted(missing)[:5]})"
                            )
                        )
                    else:
                        st.current = st.routed  # run_id-routed dataflow
                        st.routed = {}
                        if si + 1 < n_stages:
                            advance = True
                        else:
                            st.t_done = time.perf_counter()
        if advance:
            submit_stage(i, si + 1)
        done = 0
        with lock:
            outstanding[0] -= 1
            done_tasks[0] += 1
            done = done_tasks[0]
            if outstanding[0] == 0 and not seeding[0]:
                done_event.set()
        if on_progress is not None:
            on_progress(done, total_tasks)

    t0 = time.perf_counter()
    if owns_manager:
        mgr.start(cluster.n_workers)
    if spec_mode:
        # Broadcast the study context before any lease can reference it
        # (pipes are ordered). The plan id is session-unique so adaptive
        # rounds sharing one session never collide in the workers' caches.
        with _PLAN_IDS_LOCK:
            plan_id = f"plan{next(_PLAN_IDS)}"
        mgr.backend.install_study(
            plan_id=plan_id,
            recipe=plan.recipe,
            key_prefix=key_prefix,
            input_keys=list(input_keys),
            cache_enabled=plan.cache_enabled,
        )
    try:
        for i in range(len(inputs)):
            states[i].t_submit = time.perf_counter()
            submit_stage(i, 0)
        with lock:
            seeding[0] = False
            if outstanding[0] == 0:
                done_event.set()
        if shared:
            # wait for THIS study's keys only — mgr.drain() would also
            # wait on every other tenant's pending work in the session
            while not done_event.wait(0.05):
                if cancel_event is not None and cancel_event.is_set():
                    break
            if not done_event.is_set():
                raise TaskCancelled(
                    f"study cancelled: {key_prefix or '<unprefixed>'}"
                )
        else:
            mgr.drain()
    finally:
        if owns_manager:
            mgr.close()
            # submit_stage and on_bucket refer to each other: unbroken, the
            # cycle keeps the cache and the stages' outputs (device tensors)
            # alive after the call until the next cyclic collection. The
            # closed session calls neither again.
            submit_stage = on_bucket = None  # noqa: F841
        elif not shared:
            # shared session: outputs were consumed via callbacks; release
            # the memoised results so a many-round study stays bounded.
            # (In shared mode the service registry owns the release — keys
            # may still be referenced by other live jobs.)
            mgr.forget(submitted)
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0

    per_input = [
        StudyResult(
            outputs=st.current,
            tasks_executed=sum(st.executed),
            cache_hits=sum(st.hits),
            retries=0,  # session-wide: see StudyStreamResult.retries
            backups_launched=0,
            wall_seconds=st.t_done - st.t_submit,
            per_stage_executed=list(st.executed),
        )
        for st in states
    ]
    dispatch_delta = {
        name: count - dispatch0.get(name, 0)
        for name, count in mgr.dispatch_counts.items()
        if count - dispatch0.get(name, 0)
    }
    return StudyStreamResult(
        outputs={i: r.outputs for i, r in enumerate(per_input)},
        per_input=per_input,
        n_inputs=len(inputs),
        n_workers=cluster.n_workers,
        tasks_executed=sum(r.tasks_executed for r in per_input),
        cache_hits=sum(r.cache_hits for r in per_input),
        retries=mgr.retries - retries0,
        backups_launched=mgr.backups_launched - backups0,
        wall_seconds=wall,
        busy_seconds=mgr.busy_seconds - busy0,
        manager_sessions=1 if owns_manager else 0,
        cache_misses=(cache.misses - cache0[0]) if cache is not None else 0,
        cache_spills=(cache.spills - cache0[1]) if cache is not None else 0,
        cache_rehydrations=(
            (cache.rehydrations - cache0[2]) if cache is not None else 0
        ),
        backend=mgr.backend_name,
        dispatch_counts=dispatch_delta,
        scheduler=mgr.scheduler_stats(),
    )
