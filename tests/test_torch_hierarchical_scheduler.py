"""The reference's tests/test_hierarchical_scheduler.py re-targeted at ``repro_torch`` (the
import root renamed; the study generator is ``test_torch_study_gen``).

Scheduler conformance battery for the hierarchical Manager (DESIGN.md §15).

The hierarchy's contract: splitting the Manager into ``fanout`` sub-manager
pumps — with locality-aware dispatch and work stealing in any combination —
is a pure *scheduling* change. For ANY workflow, ANY parameter sets, ANY
input set and every policy × executor combination, outputs must be
**bit-identical** to the flat single-pump Manager (and therefore to the
straight-line oracle), with the accounting identity
``tasks_executed + cache_hits == plan.tasks_executed × n_inputs`` intact,
exactly one Manager session per study, and never more executed tasks than
the flat baseline. The battery also pins the spec grammar, the
scheduler-stats surface, the process-backend path, SA-index equality
through the adaptive driver, and the simulator's calibration against real
measured runs.
"""

import random
import time

import pytest

from repro_torch.engine import ClusterSpec, execute_plan, execute_study, plan_study
from repro_torch.engine.types import POLICIES
from repro_torch.runtime import (
    HierarchySpec,
    Manager,
    ProcessRpcBackend,
    parse_hierarchy,
    simulate_stream,
)
from repro_torch.runtime.hierarchy import best_affinity, path_lcp

from test_torch_study_gen import (
    mix_study_build,
    naive_outputs,
    random_layout,
    random_param_sets,
    random_workflow,
    sleep_workflow,
    workflow_from_layout,
)

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False


# ---------------------------------------------------------------------------
# Spec grammar + prefix matching units
# ---------------------------------------------------------------------------


class TestParseHierarchy:
    def test_flat_spellings(self):
        for spec in (None, "flat", "", 1, "fanout=1"):
            assert parse_hierarchy(spec).fanout == 1, spec
        assert parse_hierarchy(None) == HierarchySpec(fanout=1)

    def test_int_and_string_fanout(self):
        assert parse_hierarchy(4).fanout == 4
        assert parse_hierarchy("fanout=4").fanout == 4
        assert parse_hierarchy("4").fanout == 4  # CLI: --hierarchy 4
        assert parse_hierarchy(" 2 ").fanout == 2
        assert parse_hierarchy(0).fanout == 1  # clamped, never zero pumps

    def test_feature_flags(self):
        spec = parse_hierarchy("fanout=4,-steal,-locality,block=16,steal_min=4")
        assert spec == HierarchySpec(
            fanout=4, steal=False, locality=False, block_size=16, steal_min=4
        )
        assert parse_hierarchy("fanout=2,+steal,+locality").steal

    def test_auto_resolves_from_pool_size(self):
        spec = parse_hierarchy("auto")
        assert spec.auto
        assert spec.resolve(4).fanout == 1  # small pools stay flat
        assert spec.resolve(32).fanout == 4
        assert spec.resolve(10_000).fanout == 16  # capped
        # resolve always clamps so every pump owns >= 1 worker
        assert parse_hierarchy(8).resolve(3).fanout == 3

    def test_passthrough_and_errors(self):
        spec = HierarchySpec(fanout=3, steal=False)
        assert parse_hierarchy(spec) is spec
        with pytest.raises(ValueError, match="unknown option"):
            parse_hierarchy("fanout=2,bogus=3")
        with pytest.raises(ValueError, match="unknown token"):
            parse_hierarchy("fanout=2,wibble")
        with pytest.raises(ValueError, match="not an int"):
            parse_hierarchy("fanout=two")
        with pytest.raises(ValueError, match="must be None"):
            parse_hierarchy(3.5)

    def test_path_lcp_and_best_affinity(self):
        assert path_lcp(("a", "b", "c"), ("a", "b", "d")) == 2
        assert path_lcp(("a",), ("b",)) == 0
        assert path_lcp(None, ("a",)) == 0
        assert path_lcp((), ()) == 0
        assert best_affinity(("a", "b"), [None, ("a",), ("a", "b")]) == 2
        assert best_affinity(None, [("a",)]) == 0


# ---------------------------------------------------------------------------
# Differential conformance: fanout matrix × policy matrix × both executors
# ---------------------------------------------------------------------------

FANOUTS = (2, 4)  # vs the implicit flat (fanout=1) baseline


def _random_case(seed: int):
    rng = random.Random(seed)
    wf, names, cards = random_workflow(rng)
    sets = random_param_sets(rng, names, cards, rng.randint(2, 16))
    inputs = [rng.randrange(1 << 40) for _ in range(rng.randint(1, 3))]
    plan_kwargs = {
        "max_bucket_size": rng.choice([1, 2, 3, None]),
        "active_paths": rng.choice([1, 2, None]),
    }
    return wf, sets, inputs, plan_kwargs


@pytest.mark.parametrize("seed", range(3))
def test_conformance_fanout_matrix(seed):
    """fanout ∈ {1, 2, 4} × all five policies × execute_study: bit-identical
    outputs, exactly one session per study, accounting identity, and never
    more executed tasks than the flat run."""
    wf, sets, inputs, plan_kwargs = _random_case(7700 + seed)
    oracles = [naive_outputs(wf, sets, x) for x in inputs]
    cluster = ClusterSpec(n_workers=4)

    for pol in POLICIES:
        plan = plan_study(wf, sets, policy=pol, **plan_kwargs)
        flat = execute_study(plan, inputs, cluster=cluster)
        for i in range(len(inputs)):
            assert flat.outputs[i] == oracles[i], (pol, i)
        assert flat.scheduler["mode"] == "flat"

        for fan in FANOUTS:
            before = Manager.sessions_started
            stream = execute_study(plan, inputs, cluster=cluster, hierarchy=fan)
            # one persistent session per study — the hierarchy adds pump
            # THREADS, not sessions
            assert Manager.sessions_started - before == 1, (pol, fan)
            assert stream.manager_sessions == 1
            for i in range(len(inputs)):
                assert stream.outputs[i] == oracles[i], (pol, fan, i)
                assert stream.outputs[i] == flat.outputs[i], (pol, fan, i)
            # exactly-once accounting survives re-queueing across sub-pumps
            assert (
                stream.tasks_executed + stream.cache_hits
                == plan.tasks_executed * len(inputs)
            ), (pol, fan)
            # scheduling never ADDS work: reuse at least matches flat
            assert stream.tasks_executed <= flat.tasks_executed + flat.cache_hits
            assert stream.scheduler["fanout"] == min(fan, cluster.n_workers)


@pytest.mark.parametrize("hierarchy", ["auto", "fanout=2,-steal",
                                       "fanout=2,-locality",
                                       "fanout=4,-steal,-locality,block=1"])
def test_conformance_feature_flag_variants(hierarchy):
    """Every feature subset (no-steal, no-locality, degenerate block) is
    still bit-identical — the flags trade performance, never results."""
    wf, sets, inputs, plan_kwargs = _random_case(8800)
    oracles = [naive_outputs(wf, sets, x) for x in inputs]
    plan = plan_study(wf, sets, policy="hybrid", **plan_kwargs)
    stream = execute_study(
        plan, inputs, cluster=ClusterSpec(n_workers=4), hierarchy=hierarchy
    )
    for i in range(len(inputs)):
        assert stream.outputs[i] == oracles[i], i
    assert (
        stream.tasks_executed + stream.cache_hits
        == plan.tasks_executed * len(inputs)
    )


@pytest.mark.parametrize("policy", POLICIES)
def test_execute_plan_hierarchy_matches_flat(policy):
    """The single-input executor threads hierarchy= through to the same
    Manager — same outputs, same accounting, policy by policy."""
    wf, sets, inputs, plan_kwargs = _random_case(9900)
    oracle = naive_outputs(wf, sets, inputs[0])
    plan = plan_study(wf, sets, policy=policy, **plan_kwargs)
    cluster = ClusterSpec(n_workers=4)
    flat = execute_plan(plan, inputs[0], cluster=cluster)
    hier = execute_plan(plan, inputs[0], cluster=cluster, hierarchy=2)
    assert flat.outputs == oracle
    assert hier.outputs == oracle
    assert (
        hier.tasks_executed + hier.cache_hits
        == flat.tasks_executed + flat.cache_hits
    )


def test_external_manager_rejects_hierarchy_kwarg():
    """An external Manager session already carries its own topology;
    silently ignoring a conflicting hierarchy= would be a foot-gun."""
    wf, sets, inputs, plan_kwargs = _random_case(4242)
    plan = plan_study(wf, sets, policy="hybrid", **plan_kwargs)
    mgr = Manager(hierarchy=2)
    mgr.start(2)
    try:
        stream = execute_study(plan, inputs, manager=mgr)  # inherits fanout=2
        assert stream.outputs[0] == naive_outputs(wf, sets, inputs[0])
        with pytest.raises(ValueError, match="hierarchy"):
            execute_study(plan, inputs, manager=mgr, hierarchy=2)
    finally:
        mgr.close()


def test_scheduler_stats_surface():
    """The stats snapshot is coherent: hierarchical mode with the resolved
    fanout, every sub-pump accounted, counters non-negative, and the wall
    clock real. Locality/steal activity is workload-dependent, so only
    structure is pinned here (activity is pinned by the storm tests)."""
    rng = random.Random(606)
    wf, names, cards = random_workflow(rng, max_stages=3)
    sets = random_param_sets(rng, names, cards, 24)
    inputs = [rng.randrange(1 << 40) for _ in range(4)]
    plan = plan_study(wf, sets, policy="hybrid", max_bucket_size=1)
    stream = execute_study(
        plan, inputs, cluster=ClusterSpec(n_workers=4), hierarchy=4
    )
    sched = stream.scheduler
    assert sched["mode"] == "hierarchical"
    assert sched["fanout"] == 4
    assert len(sched["sub_occupancy"]) == 4
    assert len(sched["dispatched_per_sub"]) == 4
    # every settled bucket was dispatched by SOME sub-pump (retries/backups
    # may add more dispatches, never fewer)
    assert sum(sched["dispatched_per_sub"]) >= plan.bucket_count()
    assert sched["steals"] >= 0 and sched["steal_items"] >= sched["steals"] * 0
    assert 0.0 <= sched["locality_hit_rate"] <= 1.0
    assert sched["wall_seconds"] > 0
    assert 0.0 <= sched["pump_occupancy"]
    assert len(sched["worker_busy_seconds"]) == 4
    assert sched["worker_idle_fraction"] <= 1.0
    # flat runs advertise the flat shape
    flat = execute_study(plan, inputs, cluster=ClusterSpec(n_workers=2))
    assert flat.scheduler["mode"] == "flat"
    assert flat.scheduler["fanout"] == 1
    assert flat.scheduler["sub_occupancy"] == []


# ---------------------------------------------------------------------------
# Process backend: the hierarchy dispatches through RPC worker processes
# ---------------------------------------------------------------------------


def test_hierarchy_bit_identical_on_process_backend(tmp_path):
    """fanout=2 over RPC worker processes: sub-pumps partition the worker
    pool and drive targeted offer_batch calls concurrently; results must
    still equal the oracle and the flat thread run exactly."""
    rng = random.Random(1177)
    layout, names, cards = random_layout(rng, max_stages=2)
    wf = workflow_from_layout(layout)
    sets = random_param_sets(rng, names, cards, 10)
    inputs = [5, 13]
    oracles = [naive_outputs(wf, sets, x) for x in inputs]

    mgr = Manager(
        backend=ProcessRpcBackend(
            build=mix_study_build,
            build_kwargs={"layout": layout, "inputs": inputs},
            store_dir=str(tmp_path / "store"),
            heartbeat_interval=0.05,
        ),
        enable_backup_tasks=False,
        hierarchy=2,
    )
    mgr.start(2)
    try:
        for policy in ("stage", "hybrid"):
            plan = plan_study(wf, sets, policy=policy, max_bucket_size=2)
            stream = execute_study(
                plan, inputs, manager=mgr, key_prefix=f"{policy}:"
            )
            assert stream.backend == "process"
            for i in range(len(inputs)):
                assert stream.outputs[i] == oracles[i], (policy, i)
        assert mgr.scheduler_stats()["mode"] == "hierarchical"
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# SA indices through the adaptive driver: hierarchy changes nothing
# ---------------------------------------------------------------------------


def _objective(leaf, _i):
    return float(leaf % 9973) / 9973.0


def test_sa_indices_bit_identical_flat_vs_hierarchical():
    from repro_torch.core import ParamSpace
    from repro_torch.study import StudyDriver

    layout = [
        [("s0t0", (), 1.0, 64)],
        [
            ("s1t0", ("p0",), 1.0, 64),
            ("s1t1", ("p1",), 1.0, 64),
            ("s1t2", ("p2",), 1.0, 64),
        ],
    ]
    space = ParamSpace.from_dict({f"p{i}": [0, 1, 2] for i in range(3)})
    inputs = [417]

    def run(hierarchy):
        driver = StudyDriver(
            workflow_from_layout(layout),
            space,
            inputs,
            objective=_objective,
            seed=5,
            engine_policy="hybrid",
            cluster=ClusterSpec(n_workers=4),
            n_boot=8,
            hierarchy=hierarchy,
        )
        try:
            return driver.run(max_rounds=2)
        finally:
            driver.close()

    flat_state = run(None)
    hier_state = run("fanout=4,block=1")
    assert hier_state.evaluated == flat_state.evaluated
    assert len(hier_state.rounds) == len(flat_state.rounds) == 2
    for hr, fr in zip(hier_state.rounds, flat_state.rounds):
        assert hr.outputs == fr.outputs
        assert hr.analysis == fr.analysis  # indices + CIs, exact floats
        assert hr.decision == fr.decision
    assert hier_state.active == flat_state.active


# ---------------------------------------------------------------------------
# Hypothesis layer: shrinkable conformance over the same contract
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:

    class TestHypothesisHierarchyConformance:
        @given(
            seed=st.integers(min_value=0, max_value=2**20),
            n_runs=st.integers(min_value=1, max_value=12),
            fanout=st.sampled_from([2, 3, 4]),
            block=st.sampled_from([1, 2, 8]),
        )
        @settings(max_examples=10, deadline=None)
        def test_hierarchy_bit_identical(self, seed, n_runs, fanout, block):
            rng = random.Random(seed)
            wf, names, cards = random_workflow(rng)
            sets = random_param_sets(rng, names, cards, n_runs)
            inputs = [rng.randrange(1 << 40) for _ in range(rng.randint(1, 2))]
            oracles = [naive_outputs(wf, sets, x) for x in inputs]
            plan = plan_study(
                wf, sets, policy=rng.choice(list(POLICIES)),
                max_bucket_size=rng.choice([1, 2, None]),
            )
            stream = execute_study(
                plan,
                inputs,
                cluster=ClusterSpec(n_workers=4),
                hierarchy=HierarchySpec(fanout=fanout, block_size=block),
            )
            for i in range(len(inputs)):
                assert stream.outputs[i] == oracles[i], i
            assert (
                stream.tasks_executed + stream.cache_hits
                == plan.tasks_executed * len(inputs)
            )


# ---------------------------------------------------------------------------
# Simulator calibration: simulate_stream vs MEASURED ThreadBackend runs
# ---------------------------------------------------------------------------


def _calibration_case():
    """A sleep workflow whose declared costs ARE wall-seconds, planned so
    the per-stage bucket makespans feed simulate_stream directly."""
    wf = sleep_workflow([0.02, 0.03])
    sets = [((f"sp0", i % 4), (f"sp1", i % 3)) for i in range(8)]
    plan = plan_study(wf, sets, policy="stage", max_bucket_size=2)
    costs = [
        [b.schedule.makespan for b in stage.buckets] for stage in plan.stages
    ]
    return wf, sets, plan, costs


class TestSimulatorCalibration:
    """``simulate_stream`` is the autotuner's oracle, so its predictions
    must track reality. Tolerance (stated): a measured ThreadBackend run
    must land in ``[0.85 × predicted, 1.6 × predicted + 0.5 s]`` — the
    lower bound catches a simulator that over-charges (sleeps are real
    lower bounds on wall time), the upper bound catches one that ignores
    scheduling costs, with generous slack for loaded CI machines."""

    TOL_LOW = 0.85
    TOL_HIGH = 1.6
    TOL_SLACK = 0.5

    def _measure(self, wf, sets, plan, *, workers, hierarchy):
        t0 = time.perf_counter()
        stream = execute_study(
            plan,
            [101, 202],
            cluster=ClusterSpec(n_workers=workers, enable_backup_tasks=False),
            hierarchy=hierarchy,
        )
        measured = time.perf_counter() - t0
        assert stream.outputs[0] == naive_outputs(wf, sets, 101)
        return measured

    def _predict(self, costs, *, workers, fanout):
        sim = simulate_stream(
            costs,
            2,
            n_nodes=1,
            cores_per_node=workers,
            dispatch_latency=0.0,
            io_per_bucket=0.0,
            node_speed_sigma=0.0,
            input_cost_sigma=0.0,
            fanout=fanout,
        )
        return sim.makespan

    @pytest.mark.parametrize("fanout", [1, 2])
    def test_predicted_wall_time_tracks_measured(self, fanout):
        wf, sets, plan, costs = _calibration_case()
        predicted = self._predict(costs, workers=4, fanout=fanout)
        assert predicted > 0.05  # a real workload, not a degenerate case
        measured = self._measure(wf, sets, plan, workers=4, hierarchy=fanout)
        assert measured >= self.TOL_LOW * predicted, (measured, predicted)
        assert measured <= self.TOL_HIGH * predicted + self.TOL_SLACK, (
            measured,
            predicted,
        )

    def test_fewer_workers_predictably_slower(self):
        """Calibration is relative too: the simulator's 1-worker/4-worker
        makespan ratio must match the measured ratio's direction."""
        wf, sets, plan, costs = _calibration_case()
        p1 = self._predict(costs, workers=1, fanout=1)
        p4 = self._predict(costs, workers=4, fanout=1)
        assert p1 > p4 * 1.5  # the model scales with workers
        m1 = self._measure(wf, sets, plan, workers=1, hierarchy=None)
        m4 = self._measure(wf, sets, plan, workers=4, hierarchy=None)
        assert m1 > m4, (m1, m4)
