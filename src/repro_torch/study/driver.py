"""StudyDriver — the adaptive multi-round science loop above the engine
(DESIGN.md §11).

One round = **propose → evaluate → analyze → decide**:

1. a pluggable :mod:`sampler <repro_torch.study.samplers>` proposes the round's
   run-list (MOAT trajectories, Saltelli matrices, refinement grids over
   the currently-active parameters);
2. the driver *evaluates* it incrementally — proposals whose objective a
   prior round already produced are recalled from the
   :class:`~repro_torch.study.StudyState` evaluated map; only the **delta** is
   planned (``plan_study(..., ledger=state.ledger)``) and streamed through
   the study's single persistent Manager session with the round-shared,
   store-backed result cache, so shared trie prefixes from *any* prior
   round are cache/store hits rather than recomputation;
3. the analyzer turns the objective vector into indices (``core.sa``) with
   bootstrap confidence intervals;
4. a pluggable :mod:`policy <repro_torch.study.policies>` prunes parameters whose
   CI says they cannot matter, advances the phase (screen → VBD → refine),
   or declares convergence.

``tune`` reuses the same loop for importance-guided coordinate descent on
the objective (e.g. Dice vs a reference segmentation), where the
one-coordinate-at-a-time proposals make cross-round trie reuse maximal.

Reuse is an optimization, never an approximation: tasks are pure functions
of ``(input, params)``, so an adaptive study's indices are bit-identical to
running every round as an independent one-shot study — the tests assert
exactly that against a one-shot oracle.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.params import ParamSet, ParamSpace, paramset
from repro_torch.core.sa import moat_indices, vbd_indices
from repro_torch.core.workflow import Workflow
from repro_torch.engine import ClusterSpec, MemoryBudget, execute_study, plan_study
from repro_torch.engine.types import CACHING_POLICIES
from repro_torch.runtime.manager import Manager
from repro_torch.runtime.transport import _merge_int_tree, worker_context
from repro_torch.study.policies import Decision, ScreenThenRefinePolicy
from repro_torch.study.samplers import (
    MoatSampler,
    RefinementSampler,
    SaltelliSampler,
    active_space,
)
from repro_torch.study.state import RoundRecord, StudyState, _ps_from_json, _ps_to_json

__all__ = ["StudyDriver", "run_fleet_study"]

# objective(final_stage_output, input_index) -> scalar; the driver averages
# it over inputs to get one y per run.
Objective = Callable[[Any, int], float]


class StudyDriver:
    """Run an adaptive SA study over ``workflow`` × ``space`` on ``inputs``.

    The driver owns a :class:`StudyState` (pass one to resume) and keeps one
    Manager session alive across every round; ``close()`` (or use as a
    context manager) retires it. ``engine_policy`` is the engine's bucketing
    policy for every delta plan — it must be a caching policy
    (rtma/rmsr/hybrid) for cross-round task reuse to engage.
    """

    def __init__(
        self,
        workflow: Workflow,
        space: ParamSpace,
        inputs: Sequence[Any],
        *,
        objective: Objective,
        maximize: bool = False,
        state: Optional[StudyState] = None,
        seed: int = 0,
        engine_policy: str = "hybrid",
        max_bucket_size: Optional[int] = None,
        active_paths: Optional[int] = 4,
        memory: Optional[MemoryBudget] = None,
        cluster: Optional[ClusterSpec] = None,
        sa_policy: Optional[ScreenThenRefinePolicy] = None,
        samplers: Optional[Dict[str, Any]] = None,
        n_boot: int = 32,
        input_keys: Optional[Sequence[Any]] = None,
        store_dir: Optional[str] = None,
        backend: Any = None,
        hierarchy: Any = None,
        evaluate_delta: Optional[
            Callable[
                [Sequence[ParamSet]],
                Tuple[Dict[ParamSet, float], Dict[str, int]],
            ]
        ] = None,
    ):
        self.workflow = workflow
        self.inputs = list(inputs)
        self.objective = objective
        self.maximize = maximize
        self.state = state or StudyState(space, seed=seed, store_dir=store_dir)
        if tuple(self.state.space.names) != tuple(space.names):
            raise ValueError("resumed StudyState belongs to a different space")
        if engine_policy not in CACHING_POLICIES:
            raise ValueError(
                f"engine_policy {engine_policy!r} disables the result cache; "
                f"adaptive cross-round reuse needs one of {CACHING_POLICIES} "
                "(use app.run_study for non-caching baselines)"
            )
        self.engine_policy = engine_policy
        self.max_bucket_size = max_bucket_size
        self.active_paths = active_paths
        self.memory = memory or MemoryBudget()
        self.cluster = cluster or ClusterSpec()
        self.sa_policy = sa_policy or ScreenThenRefinePolicy()
        self.samplers = samplers or {
            "moat": MoatSampler(),
            "vbd": SaltelliSampler(),
            "refine": RefinementSampler(),
        }
        self.n_boot = n_boot
        # WorkerBackend spec for the study's persistent Manager session:
        # None/"thread" (in-process Workers) or a constructed
        # ProcessRpcBackend whose build() produces this study's workflow
        # and inputs in each worker process (DESIGN.md §13).
        self.backend = backend
        # Scheduler topology spec for the session (DESIGN.md §15):
        # None/"flat" for the single-pump Manager, int/"auto"/"fanout=N,..."
        # for hierarchical sub-manager pumps.
        self.hierarchy = hierarchy
        # Optional out-of-process evaluation hook (the fleet runner): given
        # the round's delta, returns (ParamSet -> objective, counter stats).
        # The hook owns planning/execution/state-merge; the driver keeps the
        # science loop (propose/analyze/decide) and best-point tracking.
        self._evaluate_delta = evaluate_delta
        self.input_keys = (
            list(input_keys) if input_keys is not None else list(range(len(inputs)))
        )
        if self.state.input_keys is None:
            self.state.input_keys = list(self.input_keys)
        elif self.state.input_keys != self.input_keys:
            raise ValueError(
                "resumed StudyState was built over inputs "
                f"{self.state.input_keys!r}, not {self.input_keys!r}: its "
                "evaluated objectives and stored results would be about "
                "different data"
            )

    # ------------------------------------------------------------------
    # Incremental evaluation (the delta path)
    # ------------------------------------------------------------------
    def _ensure_manager(self) -> Manager:
        st = self.state
        if st.manager is None or not st.manager.is_running:
            st.manager = Manager(
                backend=self.backend,
                max_attempts=self.cluster.max_attempts,
                heartbeat_timeout=self.cluster.heartbeat_timeout,
                straggler_factor=self.cluster.straggler_factor,
                enable_backup_tasks=self.cluster.enable_backup_tasks,
                hierarchy=self.hierarchy,
            )
            st.manager.start(self.cluster.n_workers)
        return st.manager

    def evaluate(
        self, param_sets: Sequence[ParamSet]
    ) -> Tuple[List[float], Dict[str, int]]:
        """Objective per proposed ParamSet, computing only the delta.

        Already-evaluated proposals (any prior round, or duplicates within
        this list) are recalled from the state; the rest are planned against
        the cached trie and streamed through the persistent session/cache.
        Returns ``(y, stats)`` with y aligned 1:1 to ``param_sets``.
        """
        st = self.state
        delta: List[ParamSet] = []
        seen = set()
        for ps in param_sets:
            if ps not in st.evaluated and ps not in seen:
                seen.add(ps)
                delta.append(ps)
        n_inputs = len(self.inputs)
        stats = {
            "n_new": len(delta),
            "tasks_requested": self.workflow.total_task_count(len(param_sets))
            * n_inputs,
            "planned_tasks": 0,
            "planned_known": 0,
            "tasks_executed": 0,
            "cache_hits": 0,
        }
        if delta and self._evaluate_delta is not None:
            y_by_ps, hook_stats = self._evaluate_delta(delta)
            for ps in delta:
                y = float(y_by_ps[ps])
                st.evaluated[ps] = y
                st.record_best(ps, y, maximize=self.maximize)
            for k in ("planned_tasks", "planned_known", "tasks_executed",
                      "cache_hits"):
                stats[k] = int(hook_stats.get(k, 0))
        elif delta:
            plan = plan_study(
                self.workflow,
                delta,
                memory=self.memory,
                cluster=self.cluster,
                policy=self.engine_policy,
                max_bucket_size=self.max_bucket_size,
                active_paths=self.active_paths,
                ledger=st.ledger,
            )
            st.epoch += 1
            stream = execute_study(
                plan,
                self.inputs,
                cluster=self.cluster,
                cache=st.cache,
                manager=self._ensure_manager(),
                input_keys=self.input_keys,
                key_prefix=f"r{st.epoch}:",
            )
            # execution succeeded: only now do the plan's new trie paths
            # become "known" (i.e. resolvable through the result store)
            st.ledger.add_all(plan.ledger_pending or ())
            for rid, ps in enumerate(delta):
                vals = [
                    float(self.objective(stream.outputs[i][rid], i))
                    for i in range(n_inputs)
                ]
                y = sum(vals) / len(vals)
                st.evaluated[ps] = y
                st.record_best(ps, y, maximize=self.maximize)
            stats.update(
                planned_tasks=plan.tasks_executed * n_inputs,
                planned_known=plan.tasks_known * n_inputs,
                tasks_executed=stream.tasks_executed,
                cache_hits=stream.cache_hits,
            )
        return [st.evaluated[ps] for ps in param_sets], stats

    # ------------------------------------------------------------------
    # The round loop
    # ------------------------------------------------------------------
    def _analyze(self, record: RoundRecord) -> Dict[str, Any]:
        st = self.state
        sub = active_space(st)
        y = record.outputs
        if record.meta.get("method") == "moat":
            moves = [[(int(i), p) for i, p in traj] for traj in record.meta["moves"]]
            res = moat_indices(sub, y, moves, n_boot=self.n_boot, seed=st.seed)
            return {
                "mu": res.mu,
                "mu_star": res.mu_star,
                "sigma": res.sigma,
                "mu_star_ci": res.mu_star_ci,
                "ranking": res.ranking(),
            }
        if record.meta.get("method") == "vbd":
            res = vbd_indices(
                sub, y, record.meta["n_base"], n_boot=self.n_boot, seed=st.seed
            )
            return {
                "first_order": res.first_order,
                "total": res.total,
                "first_order_ci": res.first_order_ci,
                "total_ci": res.total_ci,
                "ranking": res.ranking(),
            }
        return {}

    def run_round(self, sampler: Any) -> RoundRecord:
        """Execute one full propose → evaluate → analyze → decide round."""
        st = self.state
        prev_best = None if st.best is None else st.best[1]
        proposed, meta = sampler.propose(st, len(st.rounds))
        t0 = time.perf_counter()
        y, stats = self.evaluate(proposed)
        record = RoundRecord(
            index=len(st.rounds),
            kind=sampler.name,
            param_sets=list(proposed),
            outputs=y,
            meta=meta,
            n_proposed=len(proposed),
            wall_seconds=time.perf_counter() - t0,
            **stats,
        )
        record.analysis = self._analyze(record)
        if sampler.name in ("refine", "tune"):
            new_best = st.best[1] if st.best else None
            if prev_best is None:
                improved = float("inf")
            else:
                improved = (
                    (new_best - prev_best) if self.maximize else (prev_best - new_best)
                )
            record.analysis = {"improved": max(0.0, improved)}
        st.rounds.append(record)
        decision = self.sa_policy.decide(st, record)
        record.decision = decision.to_json()
        st.freeze(decision.prune)
        st.phase = decision.next_phase
        return record

    def run(self, *, max_rounds: int = 6) -> StudyState:
        """Drive rounds until the policy stops the study (or the budget
        runs out), picking each round's sampler by the current phase."""
        while len(self.state.rounds) < max_rounds and self.state.phase != "stop":
            sampler = self.samplers.get(self.state.phase)
            if sampler is None:
                break
            self.run_round(sampler)
        return self.state

    # ------------------------------------------------------------------
    # Importance-guided tuning (coordinate descent on the objective)
    # ------------------------------------------------------------------
    def _importance_order(self) -> List[str]:
        for record in reversed(self.state.rounds):
            ranking = record.analysis.get("ranking")
            if ranking:
                return [n for n in ranking if n in self.state.active]
        return list(self.state.active)

    def tune(
        self, *, max_sweeps: int = 2, improve_tol: float = 1e-4
    ) -> Tuple[ParamSet, float]:
        """Importance-guided coordinate descent: sweep the active parameters
        in importance order, evaluating each one's full grid with every
        other parameter pinned at the incumbent — the classic post-SA
        tuning mode (Barreiros & Teodoro 1811.11653). One-coordinate
        proposals share the incumbent's trie prefix, so each sweep is
        almost entirely served by the persistent store."""
        st = self.state
        if st.best is None:
            self.evaluate([st.space.default()])
        for _ in range(max_sweeps):
            t0 = time.perf_counter()
            prev_best = st.best[1]
            sweep_sets: List[ParamSet] = []
            sweep_stats = {
                "n_new": 0, "tasks_requested": 0, "planned_tasks": 0,
                "planned_known": 0, "tasks_executed": 0, "cache_hits": 0,
            }
            for name in self._importance_order():
                anchor = dict(st.best[0])
                param = next(p for p in st.space.params if p.name == name)
                candidates = []
                for v in param.values:
                    d = dict(anchor)
                    d[name] = v
                    candidates.append(paramset(d))
                _, stats = self.evaluate(candidates)
                for k in sweep_stats:
                    sweep_stats[k] += stats[k]
                sweep_sets.extend(candidates)
            improved = (
                (st.best[1] - prev_best) if self.maximize else (prev_best - st.best[1])
            )
            y = [st.evaluated[ps] for ps in sweep_sets]
            record = RoundRecord(
                index=len(st.rounds),
                kind="tune",
                param_sets=sweep_sets,
                outputs=y,
                meta={"method": "tune"},
                n_proposed=len(sweep_sets),
                wall_seconds=time.perf_counter() - t0,
                analysis={"improved": max(0.0, improved)},
                **sweep_stats,
            )
            st.rounds.append(record)
            record.decision = Decision(
                prune=[],
                next_phase="stop" if improved <= improve_tol else "tune",
                reason="tune sweep",
                converged=improved <= improve_tol,
            ).to_json()
            if improved <= improve_tol:
                break
        return st.best

    # ------------------------------------------------------------------
    # Lifecycle / reporting
    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        st = self.state
        if st.manager is not None:
            backend_name = st.manager.backend_name
            dispatch = dict(st.manager.dispatch_counts)
        else:  # fleet leader (evaluate_delta hook) or nothing evaluated yet
            backend_name = None
            dispatch = {}
        return {
            **st.counters(),
            "active": list(st.active),
            "frozen": dict(st.frozen),
            "phase": st.phase,
            "backend": backend_name,
            "dispatch_counts": dispatch,
            "best": None if st.best is None else {"params": dict(st.best[0]), "objective": st.best[1]},
        }

    def save(self, path: str) -> None:
        self.state.save(path)

    def close(self) -> None:
        self.state.close()

    def __enter__(self) -> "StudyDriver":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Fleet execution: N StudyDriver processes pooling ONE SharedStore
# ---------------------------------------------------------------------------
#
# ``run_fleet_study`` shards each adaptive round's delta run-list across K
# worker *processes* (``multiprocessing.get_context("spawn")``), every one
# mounting the same :class:`~repro_torch.runtime.SharedStore` directory. The
# leader keeps the science loop — its StudyDriver proposes, analyzes and
# decides exactly as single-process — and its ``evaluate_delta`` hook farms
# the execution out; after each round the workers' evaluated objectives and
# committed ledger keys are unioned back (``StudyState.merge_fleet``), so
# round N+1 plans against everything ANY process computed. Tasks are pure
# functions of (input, params): sharding cannot change an objective value,
# so the fleet's SA indices are bit-identical to the single-process run.
#
# ``build`` must be a module-level (spawn-picklable) callable returning a
# mapping with "workflow", "space", "inputs", "objective" and optionally
# "input_keys" — each process calls it once to construct its own (process-
# local, unpicklable) task functions and inputs.

FleetBuild = Callable[..., Mapping[str, Any]]

_FLEET_WORKER: Dict[str, Any] = {}  # per-process singleton driver (spawn init)


def _fleet_worker_init(
    build: FleetBuild,
    build_kwargs: Optional[Dict[str, Any]],
    store_dir: str,
    store_ram_bytes: int,
    seed: int,
    engine_policy: str,
    cluster: Optional[ClusterSpec],
    cache_bytes: Optional[int],
    worker_backend: Any = None,
) -> None:
    """Pool initializer (runs once per spawned worker): build the workflow
    in-process, mount the SharedStore, and keep one StudyDriver — with its
    persistent Manager session and store-backed cache — alive across every
    round this worker serves."""
    from repro_torch.engine.types import DEFAULT_CACHE_BYTES
    from repro_torch.runtime.storage import mount_store

    # a raising Pool initializer makes the pool respawn workers forever;
    # park the failure and surface it on the first shard instead
    try:
        spec = build(**(build_kwargs or {}))
        # store_dir is a SPEC: plain directory → flocked SharedStore,
        # "obj:<root>" → object-store tier (no shared filesystem needed)
        store = mount_store(
            store_dir, store_ram_bytes, writer_id=f"fleetw{os.getpid()}"
        )
        state = StudyState(
            spec["space"],
            seed=seed,
            cache_bytes=cache_bytes or DEFAULT_CACHE_BYTES,
            store=store,
        )
        _FLEET_WORKER["stats"] = spec.get("stats")
        _FLEET_WORKER["driver"] = StudyDriver(
            spec["workflow"],
            spec["space"],
            spec["inputs"],
            objective=spec["objective"],
            state=state,
            seed=seed,
            engine_policy=engine_policy,
            cluster=cluster,
            input_keys=spec.get("input_keys"),
            # the fleet's execution path flows through the same
            # WorkerBackend API as every other Manager session
            backend=worker_backend,
        )
    except BaseException as e:  # noqa: BLE001
        _FLEET_WORKER["init_error"] = e


def _fleet_worker_eval(args: Tuple[List[Any], List[str]]) -> Dict[str, Any]:
    """Evaluate one shard of a round's delta: seed the ledger with the
    fleet-wide union (so the delta plan knows every process's committed
    keys), execute through the shared store, then flush the cache to the
    store's disk tier — the publish point peers rehydrate from."""
    shard_json, ledger_entries = args
    if "init_error" in _FLEET_WORKER:
        raise RuntimeError(
            "fleet worker failed to initialise"
        ) from _FLEET_WORKER["init_error"]
    drv: StudyDriver = _FLEET_WORKER["driver"]
    st = drv.state
    st.ledger.merge(ledger_entries)
    known = set(st.ledger.to_list())
    shard = [_ps_from_json(ps) for ps in shard_json]
    # store counters are worker-lifetime; the leader sums per-shard deltas
    before = (st.store.corrupt, st.store.dedup_writes, st.store.disk_hits)
    y, stats = drv.evaluate(shard)
    stats["cache_flushed"] = st.cache.flush()
    report = _FLEET_WORKER.get("stats")
    return {
        # the build's own report (its device, its kernel launches), over
        # the worker's life so far
        "pid": os.getpid(),
        "build_stats": report() if report is not None else {},
        "evaluated": [[_ps_to_json(ps), y_i] for ps, y_i in zip(shard, y)],
        # only the entries THIS shard added: the leader already holds the
        # union it sent, so shipping the whole ledger back every round
        # would grow the IPC payload with total study size
        "ledger": sorted(set(st.ledger.to_list()) - known),
        "stats": stats,
        "corrupt": st.store.corrupt - before[0],
        "dedup_writes": st.store.dedup_writes - before[1],
        "store_disk_hits": st.store.disk_hits - before[2],
    }


def run_fleet_study(
    build: FleetBuild,
    build_kwargs: Optional[Dict[str, Any]] = None,
    *,
    n_procs: int = 2,
    store_dir: str,
    max_rounds: int = 4,
    seed: int = 0,
    engine_policy: str = "hybrid",
    cluster: Optional[ClusterSpec] = None,
    sa_policy: Optional[ScreenThenRefinePolicy] = None,
    samplers: Optional[Dict[str, Any]] = None,
    n_boot: int = 32,
    store_ram_bytes: int = 256 << 20,
    cache_bytes: Optional[int] = None,
    mp_context: str = "spawn",
    worker_backend: Any = None,
) -> Tuple[StudyState, Dict[str, Any]]:
    """Run one adaptive study as a fleet of ``n_procs`` StudyDriver worker
    processes pooling a single :class:`~repro_torch.runtime.SharedStore` on
    ``store_dir``. Returns ``(leader StudyState, fleet stats)``.

    The leader's state carries the merged evaluated map, ledger union and
    per-round records (stats summed across shards); ``fleet_stats`` reports
    the cross-process accounting — combined tasks executed, corrupt-entry
    reads observed anywhere in the fleet (must stay 0), double-writes the
    per-key locks elided, and cross-process store rehydrations.

    ``fleet_stats["build"]`` sums what each worker's build reports of
    itself (a ``"stats"`` callable in the build's mapping: for the
    pathology build its device and ``morph_recon`` launches) over the
    workers, as of each one's last shard; ``"worker_pids"`` names them.
    ``mp_context="fork"`` is refused where a CUDA card is present
    (:func:`repro_torch.runtime.transport.worker_context`).
    """
    if n_procs < 1:
        raise ValueError("run_fleet_study needs n_procs >= 1")
    mp = worker_context(mp_context)
    # worker_backend crosses the spawn boundary via Pool initargs, so it
    # must be a picklable SPEC — None/"thread", or a module-level zero-arg
    # factory returning a WorkerBackend. A constructed backend instance
    # holds locks/pipes and cannot be shipped; reject it here instead of
    # failing deep inside Pool creation.
    if not (
        worker_backend is None
        or isinstance(worker_backend, str)
        or (callable(worker_backend) and not hasattr(worker_backend, "offer"))
    ):
        raise ValueError(
            "worker_backend must be None, a backend spec string ('thread', "
            "'process[...]', 'socket[...]'), or a spawn-picklable factory "
            "callable returning a WorkerBackend; a constructed backend "
            "instance cannot cross the fleet's spawn boundary"
        )
    # the leader never evaluates (its evaluate_delta hook farms every delta
    # out), so a build that offers a ``leader`` flag may skip constructing
    # the objective's heavy parts (e.g. reference segmentations)
    import inspect

    leader_kwargs = dict(build_kwargs or {})
    if "leader" in inspect.signature(build).parameters:
        leader_kwargs["leader"] = True
    spec = build(**leader_kwargs)
    from repro_torch.engine.types import DEFAULT_CACHE_BYTES
    from repro_torch.runtime.storage import mount_store

    store = mount_store(store_dir, store_ram_bytes, writer_id="fleet-leader")
    state = StudyState(
        spec["space"],
        seed=seed,
        cache_bytes=cache_bytes or DEFAULT_CACHE_BYTES,
        store=store,
    )
    fleet_stats: Dict[str, Any] = {
        "n_procs": n_procs,
        "shards_dispatched": 0,
        "corrupt": 0,
        "dedup_writes": 0,
        "store_disk_hits": 0,
        "cache_flushed": 0,  # entries the workers' publish flushes persisted
        "worker_backend": worker_backend if isinstance(worker_backend, str)
        else ("thread" if worker_backend is None else "factory"),
    }
    # `pool` is assigned below, after the driver is built — creating the
    # worker processes last means a bad driver argument cannot leak a
    # spawned pool. The closure only runs inside driver.run().
    pool = None
    # ledger entries already broadcast to the pool: each round ships only
    # the union's delta, keeping per-round IPC proportional to new work
    # instead of total study size. (A worker idle for a round misses that
    # round's delta, which can only undercount its known_nodes STATS — the
    # store serves the values regardless of ledger annotations, so results
    # and reuse are unaffected.)
    broadcast: set = set()
    build_stats: Dict[int, Dict[str, Any]] = {}  # the latest report of each worker

    def fleet_evaluate(
        delta: Sequence[ParamSet],
    ) -> Tuple[Dict[ParamSet, float], Dict[str, int]]:
        # contiguous block shards: samplers emit structurally-related runs
        # adjacently (a MOAT trajectory, a Saltelli radial block), so blocks
        # keep deep shared prefixes on ONE worker — the cross-worker overlap
        # left is mostly roots, which the SharedStore dedups
        chunk = (len(delta) + n_procs - 1) // n_procs
        shards = [list(delta[i * chunk:(i + 1) * chunk]) for i in range(n_procs)]
        shards = [s for s in shards if s]
        ledger_entries = sorted(set(state.ledger.to_list()) - broadcast)
        broadcast.update(ledger_entries)
        payloads = pool.map(
            _fleet_worker_eval,
            [
                ([_ps_to_json(ps) for ps in shard], ledger_entries)
                for shard in shards
            ],
            chunksize=1,
        )
        state.merge_fleet(payloads)
        y_by_ps: Dict[ParamSet, float] = {}
        agg = {"planned_tasks": 0, "planned_known": 0, "tasks_executed": 0,
               "cache_hits": 0}
        for shard, p in zip(shards, payloads):
            for ps, (_ps_j, y) in zip(shard, p["evaluated"]):
                y_by_ps[ps] = float(y)
            for k in agg:
                agg[k] += int(p["stats"].get(k, 0))
            fleet_stats["corrupt"] += int(p["corrupt"])
            fleet_stats["dedup_writes"] += int(p["dedup_writes"])
            fleet_stats["store_disk_hits"] += int(p["store_disk_hits"])
            fleet_stats["cache_flushed"] += int(p["stats"].get("cache_flushed", 0))
            build_stats[p["pid"]] = p["build_stats"]
        fleet_stats["shards_dispatched"] += len(shards)
        return y_by_ps, agg

    driver = StudyDriver(
        spec["workflow"],
        spec["space"],
        spec["inputs"],
        objective=spec["objective"],
        state=state,
        seed=seed,
        engine_policy=engine_policy,
        cluster=cluster,
        sa_policy=sa_policy,
        samplers=samplers,
        n_boot=n_boot,
        input_keys=spec.get("input_keys"),
        evaluate_delta=fleet_evaluate,
    )
    pool = mp.Pool(
        n_procs,
        initializer=_fleet_worker_init,
        initargs=(
            build,
            build_kwargs,
            store.disk_dir,
            store_ram_bytes,
            seed,
            engine_policy,
            cluster,
            cache_bytes,
            worker_backend,
        ),
    )
    try:
        driver.run(max_rounds=max_rounds)
    finally:
        pool.close()
        pool.join()
        driver.close()
    fleet_stats["corrupt"] += state.store.corrupt
    fleet_stats["tasks_executed"] = state.tasks_executed
    fleet_stats["tasks_requested"] = state.tasks_requested
    fleet_stats["committed_keys"] = len(store.committed_keys())
    fleet_stats["worker_pids"] = sorted(build_stats)
    fleet_stats["build"] = {}
    for report in build_stats.values():
        _merge_int_tree(fleet_stats["build"], report)
    return state, fleet_stats
