"""The cases of tests/test_engine.py held against the port's engine:
plan→bucket→schedule→dispatch, policy matrix, multi-stage dataflow, result
cache — plus the RTMA bucketing edge cases and the min_active_paths /
Manager regressions. The result-cache cases that spill, flush and rehydrate
through the store (the persistence an adaptive study's resume rests on) run
with torch tensors, bf16 among them, where the reference stores arrays, and
check that a tensor of the same dtype and bits comes back."""

import threading

import pytest
import torch

from repro_torch.core import (
    ParamSpace,
    StageSpec,
    TaskSpec,
    Workflow,
    build_reuse_tree,
    halton_sequence,
    min_active_paths,
    rmsr_schedule,
    rtma_buckets,
)
from repro_torch.engine import (
    ClusterSpec,
    MemoryBudget,
    ResultCache,
    execute_bucket,
    execute_plan,
    plan_study,
)
from repro_torch.runtime import Manager, WorkItem

BYTES = 100


def make_stage(name="seg", n_tasks=3, prefix="p", bytes_per_task=BYTES, track=None):
    def make_fn(i):
        def fn(x, **kw):
            if track is not None:
                track.append(f"{name}_t{i}")
            return x + sum(kw.values())

        return fn

    tasks = tuple(
        TaskSpec(
            name=f"{name}_t{i}",
            param_names=(f"{prefix}{i}",),
            fn=make_fn(i),
            cost=1.0,
            output_bytes=bytes_per_task,
        )
        for i in range(n_tasks)
    )
    return StageSpec(name=name, tasks=tasks)


def make_sets(n, n_tasks=3, card=3, prefix="p"):
    space = ParamSpace.from_dict({f"{prefix}{i}": list(range(card)) for i in range(n_tasks)})
    return space.quantise(halton_sequence(n, space.dim))


def naive_outputs(stages, sets, x0):
    out = {}
    for rid, ps in enumerate(sets):
        d = dict(ps)
        x = x0
        for stage in stages:
            for t in stage.tasks:
                x = t.fn(x, **{k: d[k] for k in t.param_names})
        out[rid] = x
    return out


class TestPlannerPolicies:
    def test_policy_counters_ordering(self):
        stage = make_stage()
        wf = Workflow(stages=(stage,))
        sets = make_sets(40)
        plans = {
            pol: plan_study(wf, sets, policy=pol, max_bucket_size=8, active_paths=2)
            for pol in ("none", "stage", "rtma", "rmsr", "hybrid")
        }
        assert plans["none"].tasks_executed == plans["none"].tasks_total
        assert plans["stage"].tasks_executed <= plans["none"].tasks_executed
        assert plans["rtma"].tasks_executed <= plans["stage"].tasks_executed
        assert plans["rmsr"].tasks_executed <= plans["rtma"].tasks_executed
        # hybrid uses RTMA's buckets: identical task count, lower/equal peak
        assert plans["hybrid"].tasks_executed == plans["rtma"].tasks_executed
        assert plans["hybrid"].peak_bytes <= plans["rtma"].peak_bytes

    def test_unknown_policy_raises(self):
        stage = make_stage()
        with pytest.raises(ValueError):
            plan_study(Workflow(stages=(stage,)), make_sets(4), policy="zigzag")

    def test_budget_solves_bucket_and_paths(self):
        stage = make_stage(n_tasks=4, bytes_per_task=BYTES)
        wf = Workflow(stages=(stage,))
        sets = make_sets(32, n_tasks=4, card=4)
        budget = 12 * BYTES
        rtma = plan_study(wf, sets, policy="rtma", memory=MemoryBudget(bytes=budget))
        assert rtma.peak_bytes <= budget
        rmsr = plan_study(wf, sets, policy="rmsr", memory=MemoryBudget(bytes=budget))
        assert rmsr.peak_bytes <= budget
        # maximal merge executes the perfect-reuse minimum
        tree = build_reuse_tree(stage, Workflow(stages=(stage,)).instantiate(sets)[stage.name])
        assert rmsr.tasks_executed == tree.unique_task_count()

    def test_cache_reservation_stays_inside_budget(self):
        """Schedule peak is solved against bytes − cache reservation, so
        live buffers + retained cache entries together fit the budget."""
        stage = make_stage(n_tasks=4, bytes_per_task=BYTES)
        wf = Workflow(stages=(stage,))
        sets = make_sets(32, n_tasks=4, card=4)
        budget = MemoryBudget(bytes=16 * BYTES, cache_bytes=1 << 30)
        assert budget.effective_cache_bytes == 2 * BYTES  # clamped to bytes/8
        plan = plan_study(wf, sets, policy="rmsr", memory=budget)
        assert plan.peak_bytes <= budget.schedule_bytes
        assert plan.peak_bytes + budget.effective_cache_bytes <= budget.bytes

    def test_param_free_stage_collapses(self):
        norm = StageSpec(
            name="norm",
            tasks=(TaskSpec("normalize", (), fn=lambda x: x * 2, cost=1.0, output_bytes=8),),
        )
        seg = make_stage()
        wf = Workflow(stages=(norm, seg))
        sets = make_sets(16)
        for pol in ("stage", "rtma", "rmsr", "hybrid"):
            plan = plan_study(wf, sets, policy=pol, max_bucket_size=4)
            assert plan.stages[0].tasks_executed == 1, pol
        # the no-reuse baseline pays normalization per run
        plan = plan_study(wf, sets, policy="none")
        assert plan.stages[0].tasks_executed == len(sets)


class TestMultiStageDataflow:
    def test_outputs_match_naive_through_stages(self):
        s0 = make_stage("a", 2, "p")
        s1 = make_stage("b", 2, "q")
        wf = Workflow(stages=(s0, s1))
        space = ParamSpace.from_dict(
            {"p0": [0, 1], "p1": [0, 1, 2], "q0": [0, 1], "q1": [0, 1, 2]}
        )
        sets = space.quantise(halton_sequence(24, space.dim))
        want = naive_outputs((s0, s1), sets, 1.0)
        for pol in ("none", "stage", "rtma", "rmsr", "hybrid"):
            res = execute_plan(plan_study(wf, sets, policy=pol, max_bucket_size=3), 1.0)
            assert res.outputs == want, pol

    def test_no_merging_across_distinct_upstream_outputs(self):
        """Stage-1 instances whose stage-0 parameters differ receive different
        inputs and must NOT be merged, even when their own params agree."""
        s0 = make_stage("a", 1, "p")
        s1 = make_stage("b", 1, "q")
        wf = Workflow(stages=(s0, s1))
        sets = [(("p0", 1), ("q0", 5)), (("p0", 2), ("q0", 5))]
        plan = plan_study(wf, sets, policy="rmsr")
        # q0 agrees, but the two runs sit in different upstream groups
        assert plan.stages[1].tasks_executed == 2
        res = execute_plan(plan, 0.0)
        assert res.outputs[0] == 6.0 and res.outputs[1] == 7.0

    def test_plan_is_input_independent(self):
        stage = make_stage()
        wf = Workflow(stages=(stage,))
        sets = make_sets(10)
        plan = plan_study(wf, sets, policy="rmsr")
        r1 = execute_plan(plan, 0.0)
        r2 = execute_plan(plan, 100.0)
        assert all(r2.outputs[k] == r1.outputs[k] + 100.0 for k in r1.outputs)


class TestExecutorDispatch:
    def test_bit_identical_across_policies_and_workers(self):
        """Acceptance: execute_plan outputs identical across the policy
        matrix and across n_workers ∈ {1, 4}."""
        stage = make_stage("seg", 4, "p")
        wf = Workflow(stages=(stage,))
        sets = make_sets(64, n_tasks=4, card=3)
        want = naive_outputs((stage,), sets, 0.0)
        for pol in ("rtma", "rmsr", "hybrid"):
            for workers in (1, 4):
                res = execute_plan(
                    plan_study(wf, sets, policy=pol, max_bucket_size=8, active_paths=2),
                    0.0,
                    cluster=ClusterSpec(n_workers=workers),
                )
                assert res.outputs == want, (pol, workers)

    def test_executed_plus_hits_covers_plan(self):
        stage = make_stage()
        wf = Workflow(stages=(stage,))
        sets = make_sets(30)
        plan = plan_study(wf, sets, policy="rtma", max_bucket_size=4)
        res = execute_plan(plan, 0.0)
        assert res.tasks_executed + res.cache_hits == plan.tasks_executed
        assert res.tasks_executed <= plan.tasks_executed

    def test_cache_disabled_for_baseline_policies(self):
        stage = make_stage()
        wf = Workflow(stages=(stage,))
        sets = make_sets(12, card=1)  # all identical: maximal sharing bait
        plan = plan_study(wf, sets, policy="none")
        res = execute_plan(plan, 0.0)
        assert res.cache_hits == 0
        assert res.tasks_executed == plan.tasks_total


# The stored values of the spill/flush/rehydrate cases: tensors as the
# pathology tasks produce them (a float32 image, a bf16 payload, a boolean
# mask inside a task-state dict), each standing for the reference's float.
VALUES = {
    "f32": lambda x: torch.full((4, 4), x, dtype=torch.float32),
    "bf16": lambda x: torch.full((3,), x, dtype=torch.bfloat16),
    "state": lambda x: {"gray": torch.full((2, 2), x), "mask": torch.arange(4) < x},
}


@pytest.fixture(params=sorted(VALUES))
def value(request):
    return VALUES[request.param]


def _same(got, want):
    """The same tensors back: type, dtype, shape and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
        return
    assert isinstance(got, torch.Tensor), type(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


class TestResultCache:
    def test_backup_replay_never_recomputes(self):
        """Re-executing a bucket (retry / straggler backup) with the shared
        cache re-runs zero tasks."""
        calls = []
        stage = make_stage(track=calls)
        wf = Workflow(stages=(stage,))
        sets = make_sets(10)
        plan = plan_study(wf, sets, policy="rmsr")
        bucket = plan.stages[0].buckets[0]
        cache = ResultCache(1 << 20)
        out1, exec1, hits1 = execute_bucket(bucket, 0.0, cache)
        n_first = len(calls)
        out2, exec2, hits2 = execute_bucket(bucket, 0.0, cache)
        assert out2 == out1
        assert exec1 == n_first and hits1 == 0
        assert exec2 == 0 and hits2 == exec1
        assert len(calls) == n_first  # no new task invocations

    def test_sibling_buckets_share_merged_prefixes(self):
        stage = make_stage()
        wf = Workflow(stages=(stage,))
        sets = make_sets(24, card=2)
        plan = plan_study(wf, sets, policy="rtma", max_bucket_size=3)
        res = execute_plan(plan, 0.0)
        # cross-bucket duplicate prefixes become hits, not recomputation
        full_tree = build_reuse_tree(
            stage, Workflow(stages=(stage,)).instantiate(sets)[stage.name]
        )
        assert res.tasks_executed == full_tree.unique_task_count()
        assert res.cache_hits == plan.tasks_executed - res.tasks_executed

    def test_byte_bound_evicts_lru(self):
        cache = ResultCache(100)
        cache.put(("a",), 1, 60)
        cache.put(("b",), 2, 60)  # evicts ("a",)
        hit_a, _ = cache.get(("a",))
        hit_b, val = cache.get(("b",))
        assert not hit_a and hit_b and val == 2

    def test_oversized_entry_not_admitted(self):
        cache = ResultCache(10)
        cache.put(("big",), 1, 100)
        hit, _ = cache.get(("big",))
        assert not hit

    def test_eviction_spills_to_store_and_rehydrates(self, value):
        from repro_torch.runtime import HierarchicalStore

        store = HierarchicalStore(ram_bytes=1 << 20)
        cache = ResultCache(100, spill_store=store)
        cache.put(("a",), value(1.0), 60)
        cache.put(("b",), value(2.0), 60)  # evicts ("a",) -> spilled, not dropped
        assert cache.spills == 1
        hit_a, val_a = cache.get(("a",))
        assert hit_a
        _same(val_a, value(1.0))
        assert cache.rehydrations == 1
        assert cache.hits == 1 and cache.misses == 0

    def test_oversized_entry_spills_when_store_present(self, value):
        from repro_torch.runtime import HierarchicalStore

        cache = ResultCache(10, spill_store=HierarchicalStore(ram_bytes=1 << 20))
        cache.put(("big",), value(7.0), 100)
        assert cache.spills == 1
        hit, val = cache.get(("big",))
        assert hit
        _same(val, value(7.0))

    def test_flush_persists_ram_entries_to_disk(self, tmp_path, value):
        from repro_torch.runtime import HierarchicalStore

        store = HierarchicalStore(ram_bytes=1 << 20, disk_dir=str(tmp_path))
        cache = ResultCache(1 << 10, spill_store=store)
        cache.put(("x",), value(3.0), 8)
        cache.flush()
        # a cold cache over a re-opened store resolves the key from disk
        cold = ResultCache(
            1 << 10,
            spill_store=HierarchicalStore(ram_bytes=1 << 20, disk_dir=str(tmp_path)),
        )
        hit, val = cold.get(("x",))
        assert hit and cold.rehydrations == 1
        _same(val, value(3.0))

    def test_flush_also_persists_previously_evicted_entries(self, tmp_path, value):
        """An entry evicted into the store's RAM tier before flush() must
        still reach disk: resume would otherwise silently recompute exactly
        the entries that eviction produced."""
        from repro_torch.runtime import HierarchicalStore

        store = HierarchicalStore(ram_bytes=1 << 20, disk_dir=str(tmp_path))
        cache = ResultCache(100, spill_store=store)
        cache.put(("a",), value(1.0), 60)
        cache.put(("b",), value(2.0), 60)  # evicts ("a",) -> store RAM tier only
        cache.flush()
        cold = ResultCache(
            100,
            spill_store=HierarchicalStore(ram_bytes=1 << 20, disk_dir=str(tmp_path)),
        )
        for key, want in ((("a",), 1.0), (("b",), 2.0)):
            hit, val = cold.get(key)
            assert hit, key
            _same(val, value(want))

    def test_rehydration_does_not_readmit_oversized_entries(self, value):
        """A deliberately-never-admitted entry (declared bytes > cap) must
        not slip into the RAM tier via a store round-trip: the declared
        byte model governs admission, not the measured payload size."""
        from repro_torch.runtime import HierarchicalStore

        cache = ResultCache(10, spill_store=HierarchicalStore(ram_bytes=1 << 20))
        cache.put(("big",), value(7.0), 100)  # spilled, never admitted
        for expect_rehydrations in (1, 2):
            hit, val = cache.get(("big",))
            assert hit
            _same(val, value(7.0))
            assert cache.rehydrations == expect_rehydrations  # still not RAM
        assert cache._bytes == 0


class TestRTMAEdgeCases:
    def test_max_bucket_size_one(self):
        stage = make_stage()
        insts = Workflow(stages=(stage,)).instantiate(make_sets(9))[stage.name]
        buckets = rtma_buckets(stage, insts, 1)
        assert len(buckets) == 9
        assert all(len(b.instances) == 1 for b in buckets)
        rids = sorted(i.run_id for b in buckets for i in b.instances)
        assert rids == list(range(9))  # exact partition

    def test_all_identical_instances_single_leaf(self):
        stage = make_stage()
        sets = make_sets(10, card=1)  # every run identical -> one trie leaf
        insts = Workflow(stages=(stage,)).instantiate(sets)[stage.name]
        buckets = rtma_buckets(stage, insts, 4)
        sizes = sorted(len(b.instances) for b in buckets)
        assert sizes == [2, 4, 4]
        rids = sorted(i.run_id for b in buckets for i in b.instances)
        assert rids == list(range(10))

    def test_partial_root_bucket(self):
        stage = make_stage(n_tasks=1)
        # disjoint single-param instances: no sharing anywhere, leftovers
        # bubble to the root and form one final under-full bucket
        sets = [(("p0", i),) for i in range(7)]
        insts = Workflow(stages=(stage,)).instantiate(sets)[stage.name]
        buckets = rtma_buckets(stage, insts, 3)
        sizes = [len(b.instances) for b in buckets]
        assert sum(sizes) == 7
        assert all(s <= 3 for s in sizes)
        assert sum(1 for s in sizes if s < 3) == 1  # exactly one partial bucket
        rids = sorted(i.run_id for b in buckets for i in b.instances)
        assert rids == list(range(7))


class TestMinActivePathsRegression:
    def test_exact_not_power_of_two(self):
        """The doubling search used to return only powers of two; the binary
        search must find the true largest fitting active_paths."""
        stage = make_stage(n_tasks=4, bytes_per_task=BYTES)
        sets = make_sets(64, n_tasks=4, card=4)
        insts = Workflow(stages=(stage,)).instantiate(sets)[stage.name]
        tree = build_reuse_tree(stage, insts)
        n_leaves = len(tree.leaves())
        peaks = {p: rmsr_schedule(tree, p).peak_bytes for p in range(1, n_leaves + 1)}
        probed_budgets = sorted(set(peaks.values()))
        assert any(
            max(p for p in peaks if peaks[p] <= b) not in (1, 2, 4, 8, 16, 32, 64)
            for b in probed_budgets
        ), "test vector too weak: every answer is a power of two"
        for budget in probed_budgets:
            want = max(p for p in peaks if peaks[p] <= budget)
            assert min_active_paths(tree, budget) == want, budget

    def test_below_minimum_returns_none(self):
        stage = make_stage()
        insts = Workflow(stages=(stage,)).instantiate(make_sets(8))[stage.name]
        tree = build_reuse_tree(stage, insts)
        assert min_active_paths(tree, 0) is None

    def test_huge_budget_returns_leaf_count(self):
        stage = make_stage()
        insts = Workflow(stages=(stage,)).instantiate(make_sets(11, card=4))[stage.name]
        tree = build_reuse_tree(stage, insts)
        assert min_active_paths(tree, 10**12) == len(tree.leaves())


class TestManagerRaceRegression:
    def test_no_premature_exit_under_contention(self):
        """The empty-queue/empty-running window between dequeue and lease
        registration used to let workers exit early; dequeue+lease are now
        atomic, so every run must return all results."""
        for trial in range(30):
            mgr = Manager(enable_backup_tasks=False)
            n = 60
            for i in range(n):
                mgr.submit(WorkItem(key=f"k{i}", fn=lambda i=i: i))
            out = mgr.run(8, expected=n)
            assert len(out) == n, f"trial {trial}: premature exit, {len(out)}/{n}"

    def test_retry_not_dropped_at_idle_check(self):
        """A failing item re-enqueued by a peer must be seen by idling
        workers (resubmit happens under the same lock as lease release)."""
        attempts = {"n": 0}
        lock = threading.Lock()

        def flaky():
            with lock:
                attempts["n"] += 1
                if attempts["n"] < 3:
                    raise RuntimeError("transient")
            return "ok"

        for _ in range(10):
            attempts["n"] = 0
            mgr = Manager(max_attempts=5, enable_backup_tasks=False)
            mgr.submit(WorkItem(key="flaky", fn=flaky))
            for i in range(4):
                mgr.submit(WorkItem(key=f"pad{i}", fn=lambda: "p"))
            out = mgr.run(6, expected=5)
            assert out["flaky"] == "ok"
