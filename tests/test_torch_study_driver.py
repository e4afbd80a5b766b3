"""The cases of tests/test_study_driver.py held against the port's study
driver (``repro_torch.study``): an adaptive MOAT → prune → VBD study
executes strictly fewer tasks than the same rounds run as independent
one-shot studies — asserted via cache counters — while producing
bit-identical objective vectors and indices to the one-shot oracle; and a
study resumed from a persisted StudyState + disk store recomputes zero
already-cached tasks. The TABLE1_SPACE version runs the real pathology
workflow on torch tensors.

Added for the port: the resume cases over a plain directory store and an
``obj:<root>`` object store with task outputs that are torch tensors (they
come back as tensors), and the pathology adaptive study resumed from its
``obj:`` store with zero recompute.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import ParamSpace, StageSpec, TaskSpec, Workflow
from repro_torch.core.params import ParamSet
from repro_torch.core.sa import moat_indices, vbd_indices
from repro_torch.engine import ClusterSpec, execute_study, plan_study
from repro_torch.runtime.manager import Manager
from repro_torch.study import (
    MoatSampler,
    RefinementSampler,
    SaltelliSampler,
    ScreenThenRefinePolicy,
    StudyDriver,
    StudyState,
    active_space,
)

WEIGHTS = (8.0, 0.0, 2.0, 0.01)  # per-task param weight: p1 inert, p3 ~inert


def make_workflow(calls=None):
    """(param-free norm, 4-task seg); task i adds WEIGHTS[i] * p_i."""

    def make_fn(i):
        def fn(x, **kw):
            if calls is not None:
                calls.append(i)
            return x + WEIGHTS[i] * sum(kw.values())

        return fn

    norm = StageSpec(
        name="norm",
        tasks=(TaskSpec("normalize", (), fn=lambda x: x * 2.0, cost=1.0, output_bytes=8),),
    )
    seg = StageSpec(
        name="seg",
        tasks=tuple(
            TaskSpec(
                name=f"seg_t{i}",
                param_names=(f"p{i}",),
                fn=make_fn(i),
                cost=1.0,
                output_bytes=64,
            )
            for i in range(4)
        ),
    )
    return Workflow(stages=(norm, seg))


SPACE = ParamSpace.from_dict({f"p{i}": [0.0, 1.0, 2.0, 3.0] for i in range(4)})


def make_driver(calls=None, state=None, **kw):
    kw.setdefault("seed", 13)
    kw.setdefault("n_boot", 16)
    return StudyDriver(
        make_workflow(calls),
        SPACE,
        [1.0],
        objective=lambda out, i: float(out),
        state=state,
        **kw,
    )


def oneshot_round(workflow, param_sets, inputs):
    """One round as an independent study: fresh plan, cache, session."""
    uniq = list(dict.fromkeys(param_sets))
    plan = plan_study(workflow, uniq, policy="hybrid", active_paths=4)
    stream = execute_study(plan, inputs)
    y_by_ps = {}
    for rid, ps in enumerate(uniq):
        vals = [float(stream.outputs[i][rid]) for i in range(len(inputs))]
        y_by_ps[ps] = sum(vals) / len(vals)
    return [y_by_ps[ps] for ps in param_sets], stream.tasks_executed


class TestAdaptiveVsOneShot:
    def test_strictly_fewer_tasks_and_bit_identical_outputs(self):
        driver = make_driver()
        try:
            state = driver.run(max_rounds=4)
        finally:
            driver.close()
        assert len(state.rounds) >= 2
        assert {r.kind for r in state.rounds} >= {"moat", "vbd"}

        oneshot_total = 0
        for record in state.rounds:
            y, executed = oneshot_round(
                driver.workflow, record.param_sets, driver.inputs
            )
            oneshot_total += executed
            assert y == record.outputs, record.kind  # bit-identical
        # strictly fewer tasks: asserted via the measured cache counters
        assert state.tasks_executed < oneshot_total
        # every avoided execution is visible as reuse, not silently dropped
        assert state.cache.hits > 0

    def test_indices_bit_identical_to_oracle(self):
        driver = make_driver()
        try:
            state = driver.run(max_rounds=3)
        finally:
            driver.close()
        for record in state.rounds:
            y, _ = oneshot_round(driver.workflow, record.param_sets, driver.inputs)
            if record.kind == "moat":
                names = list(record.analysis["mu_star"])
                sub = ParamSpace(tuple(p for p in SPACE.params if p.name in names))
                moves = [[(int(i), p) for i, p in t] for t in record.meta["moves"]]
                res = moat_indices(sub, y, moves, n_boot=16, seed=state.seed)
                assert res.mu_star == record.analysis["mu_star"]
                assert res.mu_star_ci == record.analysis["mu_star_ci"]
            elif record.kind == "vbd":
                names = list(record.analysis["total"])
                sub = ParamSpace(tuple(p for p in SPACE.params if p.name in names))
                res = vbd_indices(
                    sub, y, record.meta["n_base"], n_boot=16, seed=state.seed
                )
                assert res.total == record.analysis["total"]
                assert res.first_order == record.analysis["first_order"]

    def test_single_persistent_manager_session(self):
        before = Manager.sessions_started
        driver = make_driver()
        try:
            driver.run(max_rounds=4)
            # the shared session must not accumulate memoised bucket
            # outputs across rounds (unbounded growth over a long study)
            assert driver.state.manager.results() == {}
        finally:
            driver.close()
        assert Manager.sessions_started - before == 1

    def test_n_boot_zero_runs_without_cis(self):
        """n_boot=0 must fall back to point-estimate pruning (analysis
        stores ci=None), not crash the policy."""
        driver = make_driver(n_boot=0)
        try:
            state = driver.run(max_rounds=3)
        finally:
            driver.close()
        assert len(state.rounds) >= 2
        assert state.rounds[0].analysis["mu_star_ci"] is None
        assert "p1" not in state.active  # pruning still happened on points

    def test_non_caching_engine_policy_rejected(self):
        with pytest.raises(ValueError, match="caching"):
            make_driver(engine_policy="stage")

    def test_resume_with_different_inputs_rejected(self, tmp_path):
        ckpt = str(tmp_path / "state.json")
        driver = make_driver(store_dir=str(tmp_path / "store"), input_keys=["a"])
        try:
            driver.run(max_rounds=1)
            driver.save(ckpt)
        finally:
            driver.close()
        st2 = StudyState.load(ckpt)
        with pytest.raises(ValueError, match="different data"):
            make_driver(state=st2, input_keys=["b"])

    def test_last_survivor_is_most_important(self):
        """When every parameter falls below the prune cutoff (min_active=0),
        the spared parameter must be the TOP of the ranking, not the tail."""
        from repro_torch.study.state import RoundRecord

        st = StudyState(SPACE, seed=0)
        record = RoundRecord(
            index=0, kind="moat", param_sets=[], outputs=[], meta={},
            analysis={
                "mu_star": {"p0": 1.0, "p1": 0.5, "p2": 0.3, "p3": 0.2},
                # every CI-upper below 10% of max mu* -> all prunable
                "mu_star_ci": {n: (0.0, 0.01) for n in SPACE.names},
            },
        )
        decision = ScreenThenRefinePolicy(min_active=0).decide(st, record)
        assert set(SPACE.names) - set(decision.prune) == {"p0"}

    def test_failed_round_commits_nothing_to_ledger(self):
        """Ledger membership means "the store holds this output": a round
        whose execution fails permanently must not record its paths."""

        def boom(x, **kw):
            raise RuntimeError("permanent")

        norm = StageSpec(
            name="norm",
            tasks=(TaskSpec("normalize", (), fn=boom, cost=1.0, output_bytes=8),),
        )
        seg = StageSpec(
            name="seg",
            tasks=(TaskSpec("seg_t0", ("p0",), fn=boom, cost=1.0, output_bytes=8),),
        )
        wf = Workflow(stages=(norm, seg))
        space = ParamSpace.from_dict({"p0": [0.0, 1.0]})
        driver = StudyDriver(
            wf, space, [1.0], objective=lambda out, i: float(out), seed=1,
            cluster=ClusterSpec(max_attempts=1, enable_backup_tasks=False),
        )
        try:
            with pytest.raises(RuntimeError):
                driver.run_round(MoatSampler(1))
        finally:
            driver.close()
        assert len(driver.state.ledger) == 0
        assert driver.state.evaluated == {}

    def test_policy_prunes_inert_parameters(self):
        driver = make_driver(sa_policy=ScreenThenRefinePolicy(min_active=2))
        try:
            state = driver.run(max_rounds=4)
        finally:
            driver.close()
        # p0 (weight 8) and p2 (weight 2) dominate; the near-inert params go
        assert "p0" in state.active and "p2" in state.active
        assert "p1" not in state.active
        assert set(state.frozen) == set(SPACE.names) - set(state.active)

    def test_incremental_plan_reports_known_nodes(self):
        driver = make_driver()
        try:
            state = driver.run(max_rounds=3)
        finally:
            driver.close()
        later = [r for r in state.rounds if r.index > 0 and r.n_new > 0]
        assert later, "study ended before any incremental round"
        # the parameter-free norm stage is in the ledger from round 1, so
        # every later delta plan must see known prefix work
        assert any(r.planned_known > 0 for r in later)
        for r in state.rounds:
            assert r.planned_tasks >= r.planned_known >= 0


class TestResume:
    def test_resume_recomputes_zero_tasks(self, tmp_path):
        """Persisted state + content-addressed disk store: a fresh process
        re-executing round 1's exact run-list gets 100% store hits."""
        store_dir = str(tmp_path / "store")
        ckpt = str(tmp_path / "state.json")
        driver = make_driver(store_dir=store_dir)
        try:
            rec1 = driver.run_round(MoatSampler(2))
            assert rec1.tasks_executed > 0
            driver.save(ckpt)
        finally:
            driver.close()

        # "new process": fresh python objects, fresh (empty) RAM tiers
        calls2 = []
        st2 = StudyState.load(ckpt)
        assert len(st2.evaluated) > 0 and len(st2.ledger) > 0
        drv2 = make_driver(calls2, state=st2)
        try:
            # (a) re-proposing evaluated sets is elided entirely
            y, stats = drv2.evaluate(rec1.param_sets)
            assert stats["n_new"] == 0 and stats["tasks_executed"] == 0
            assert y == rec1.outputs
            assert calls2 == []
            # (b) even forcing the full plan through the engine, the store
            # rehydrates every task: zero recomputation
            plan = plan_study(
                drv2.workflow, list(dict.fromkeys(rec1.param_sets)),
                policy="hybrid", active_paths=4,
            )
            st2.epoch += 1
            stream = execute_study(
                plan, drv2.inputs,
                cache=st2.cache, manager=drv2._ensure_manager(),
                input_keys=drv2.input_keys, key_prefix=f"r{st2.epoch}:",
            )
            assert stream.tasks_executed == 0
            assert calls2 == []
            assert st2.cache.rehydrations > 0
            for rid, ps in enumerate(dict.fromkeys(rec1.param_sets)):
                assert float(stream.outputs[0][rid]) == st2.evaluated[ps]
        finally:
            drv2.close()

    def test_resumed_study_continues_rounds(self, tmp_path):
        ckpt = str(tmp_path / "state.json")
        driver = make_driver(store_dir=str(tmp_path / "store"))
        try:
            driver.run(max_rounds=1)
            driver.save(ckpt)
            phase = driver.state.phase
        finally:
            driver.close()
        st2 = StudyState.load(ckpt)
        assert st2.phase == phase
        drv2 = make_driver(state=st2)
        try:
            state = drv2.run(max_rounds=3)
        finally:
            drv2.close()
        assert len(state.rounds) >= 2

    def test_state_roundtrip_preserves_everything(self, tmp_path):
        ckpt = str(tmp_path / "state.json")
        driver = make_driver(store_dir=str(tmp_path / "store"))
        try:
            state = driver.run(max_rounds=2)
            driver.save(ckpt)
        finally:
            driver.close()
        st2 = StudyState.load(ckpt)
        assert st2.evaluated == state.evaluated
        assert st2.active == state.active and st2.frozen == state.frozen
        assert st2.best == state.best and st2.epoch == state.epoch
        assert len(st2.rounds) == len(state.rounds)
        for a, b in zip(st2.rounds, state.rounds):
            assert a.param_sets == b.param_sets
            assert a.outputs == b.outputs
            assert a.kind == b.kind and a.tasks_executed == b.tasks_executed
        assert st2.ledger.to_list() == state.ledger.to_list()


class TestTune:
    def test_coordinate_descent_finds_separable_minimum(self):
        driver = make_driver()
        try:
            best_ps, best_y = driver.tune(max_sweeps=3)
        finally:
            driver.close()
        # objective = norm(1.0) + Σ w_i p_i = 2 + Σ w_i p_i, minimised at
        # p_i = 0 for every weighted param (p1 is inert: any value ties)
        best = dict(best_ps)
        assert best["p0"] == 0.0 and best["p2"] == 0.0 and best["p3"] == 0.0
        assert best_y == 2.0

    def test_tune_reuses_prefixes(self):
        calls = []
        driver = make_driver(calls)
        try:
            driver.tune(max_sweeps=2)
            summary = driver.summary()
        finally:
            driver.close()
        # one-coordinate-at-a-time proposals share trie prefixes: measured
        # executions must undercut the naive run count substantially
        assert summary["tasks_executed"] < summary["tasks_requested"]
        assert summary["reuse_factor"] > 1.5
        assert len(calls) == sum(1 for _ in calls)  # sanity


class TestSamplers:
    def test_samplers_deterministic(self):
        s1 = StudyState(SPACE, seed=5)
        s2 = StudyState(SPACE, seed=5)
        for sampler in (MoatSampler(2), SaltelliSampler(4)):
            a, ma = sampler.propose(s1, 0)
            b, mb = sampler.propose(s2, 0)
            assert a == b and ma == mb

    def test_proposals_complete_frozen_params(self):
        st = StudyState(SPACE, seed=5)
        st.best = (SPACE.default(), 0.0)
        st.freeze(["p1", "p3"])
        sub = active_space(st)
        assert sub.names == ("p0", "p2")
        for sampler in (MoatSampler(1), SaltelliSampler(2), RefinementSampler()):
            sets, _ = sampler.propose(st, 1)
            for ps in sets:
                d = dict(ps)
                assert set(d) == set(SPACE.names)
                for name, val in st.frozen.items():
                    assert d[name] == val


class TestTable1Acceptance:
    """The adaptive-study acceptance on the real pathology workflow."""

    def test_adaptive_moat_prune_vbd_over_table1(self):
        from repro_torch.app import TABLE1_SPACE, synthetic_tile
        from repro_torch.app.pipeline import build_workflow
        from repro_torch.core import dice

        size = 24
        wf = build_workflow(size, size)
        tile = {"raw": torch.from_numpy(synthetic_tile(size, size, seed=2))}
        ref_plan = plan_study(
            wf, [TABLE1_SPACE.default()], policy="rmsr", active_paths=1
        )
        ref_mask = execute_study(ref_plan, [tile]).outputs[0][0]["mask"]

        def objective(leaf, _i):
            return 1.0 - float(dice(leaf["mask"], ref_mask))

        driver = StudyDriver(
            wf, TABLE1_SPACE, [tile],
            objective=objective, seed=6,
            samplers={"moat": MoatSampler(1), "vbd": SaltelliSampler(2),
                      "refine": RefinementSampler()},
            n_boot=8, input_keys=["tile0"],
        )
        try:
            state = driver.run(max_rounds=2)
        finally:
            driver.close()
        kinds = [r.kind for r in state.rounds]
        assert kinds[:2] == ["moat", "vbd"]
        assert len(state.active) < TABLE1_SPACE.dim  # screening pruned

        # one-shot oracle: same rounds as independent studies
        oneshot_total = 0
        for record in state.rounds:
            uniq = list(dict.fromkeys(record.param_sets))
            plan = plan_study(wf, uniq, policy="hybrid", active_paths=4)
            stream = execute_study(plan, [tile])
            oneshot_total += stream.tasks_executed
            y_by_ps = {
                ps: 1.0 - float(dice(stream.outputs[0][rid]["mask"], ref_mask))
                for rid, ps in enumerate(uniq)
            }
            y = [y_by_ps[ps] for ps in record.param_sets]
            assert y == record.outputs, record.kind  # bit-identical runs

            # …and therefore bit-identical indices
            if record.kind == "moat":
                sub = ParamSpace(
                    tuple(p for p in TABLE1_SPACE.params
                          if p.name in record.analysis["mu_star"])
                )
                moves = [[(int(i), p) for i, p in t] for t in record.meta["moves"]]
                res = moat_indices(sub, y, moves, n_boot=8, seed=state.seed)
                assert res.mu_star == record.analysis["mu_star"]
            if record.kind == "vbd":
                sub = ParamSpace(
                    tuple(p for p in TABLE1_SPACE.params
                          if p.name in record.analysis["total"])
                )
                res = vbd_indices(sub, y, record.meta["n_base"],
                                  n_boot=8, seed=state.seed)
                assert res.total == record.analysis["total"]

        # strictly fewer tasks, visible through the measured counters
        assert state.tasks_executed < oneshot_total


# ---------------------------------------------------------------------------
# Resume with tensor task outputs, over both store kinds
# ---------------------------------------------------------------------------


def make_tensor_workflow(calls=None):
    """The toy workflow with torch tensors for task outputs: task i adds
    WEIGHTS[i] * p_i to every element of a float32 vector."""

    def make_fn(i):
        def fn(x, **kw):
            if calls is not None:
                calls.append(i)
            return x + WEIGHTS[i] * sum(kw.values())

        return fn

    norm = StageSpec(
        name="norm",
        tasks=(TaskSpec("normalize", (), fn=lambda x: x * 2.0, cost=1.0, output_bytes=16),),
    )
    seg = StageSpec(
        name="seg",
        tasks=tuple(
            TaskSpec(f"seg_t{i}", (f"p{i}",), fn=make_fn(i), cost=1.0, output_bytes=16)
            for i in range(4)
        ),
    )
    return Workflow(stages=(norm, seg))


def make_tensor_driver(calls=None, state=None, **kw):
    return StudyDriver(
        make_tensor_workflow(calls),
        SPACE,
        [torch.arange(4, dtype=torch.float32)],
        objective=lambda out, i: float(out.sum()),
        state=state,
        seed=13,
        n_boot=16,
        **kw,
    )


@pytest.mark.parametrize("kind", ["dir", "obj"])
def test_resume_gives_back_tensors_with_zero_recompute(tmp_path, kind):
    store_dir = str(tmp_path / "store")
    if kind == "obj":
        store_dir = "obj:" + store_dir
    ckpt = str(tmp_path / "state.json")
    driver = make_tensor_driver(store_dir=store_dir)
    try:
        rec1 = driver.run_round(MoatSampler(2))
        assert rec1.tasks_executed > 0
        driver.save(ckpt)
    finally:
        driver.close()

    calls = []
    st2 = StudyState.load(ckpt)
    assert st2.store.disk_dir == store_dir
    if kind == "obj":
        assert type(st2.store).__name__ == "ObjectBackedStore"
    drv2 = make_tensor_driver(calls, state=st2)
    try:
        y, stats = drv2.evaluate(rec1.param_sets)
        assert stats["n_new"] == 0 and stats["tasks_executed"] == 0
        assert y == rec1.outputs and calls == []
        uniq = list(dict.fromkeys(rec1.param_sets))
        plan = plan_study(drv2.workflow, uniq, policy="hybrid", active_paths=4)
        st2.epoch += 1
        stream = execute_study(
            plan, drv2.inputs,
            cache=st2.cache, manager=drv2._ensure_manager(),
            input_keys=drv2.input_keys, key_prefix=f"r{st2.epoch}:",
        )
        assert stream.tasks_executed == 0 and calls == []
        assert st2.cache.rehydrations > 0 and st2.store.disk_hits > 0
        for rid, ps in enumerate(uniq):
            out = stream.outputs[0][rid]
            assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
            assert float(out.sum()) == st2.evaluated[ps]
    finally:
        drv2.close()


def test_pathology_adaptive_study_resumes_from_obj_store(tmp_path):
    """``run_adaptive_study`` over an ``obj:`` store, saved, loaded into a
    fresh StudyDriver over the same tiles: re-running round 1's run list
    through the engine executes zero tasks, and the rehydrated task states
    are tensors equal to the recorded objectives."""
    from repro_torch.app import TABLE1_SPACE, run_adaptive_study, synthetic_tile
    from repro_torch.app.pipeline import build_workflow
    from repro_torch.core import dice

    size = 24
    tiles = [synthetic_tile(size, size, seed=s) for s in (4, 5)]
    store_dir = f"obj:{tmp_path / 'store'}"
    out = run_adaptive_study(tiles, max_rounds=2, n_trajectories=1, n_base=2, n_boot=8,
                             seed=3, store_dir=store_dir, device="cpu")
    state = out["state"]
    assert [r.kind for r in state.rounds] == ["moat", "vbd"]
    ckpt = str(tmp_path / "state.json")
    state.save(ckpt)

    st2 = StudyState.load(ckpt)
    assert st2.store.disk_dir == store_dir
    ref_masks = [torch.from_numpy(m) for m in out["reference_masks"]]
    raws = [{"raw": torch.from_numpy(t)} for t in tiles]

    def objective(leaf, i):
        return 1.0 - float(dice(leaf["mask"], ref_masks[i]))

    wf = build_workflow(size, size)
    drv2 = StudyDriver(wf, TABLE1_SPACE, raws, objective=objective, state=st2,
                       input_keys=["tile0", "tile1"])
    try:
        rec1 = st2.rounds[0]
        y, stats = drv2.evaluate(rec1.param_sets)
        assert stats["n_new"] == 0 and stats["tasks_executed"] == 0
        assert y == rec1.outputs
        uniq = list(dict.fromkeys(rec1.param_sets))
        plan = plan_study(wf, uniq, policy="hybrid", active_paths=4)
        st2.epoch += 1
        stream = execute_study(plan, raws, cache=st2.cache, manager=drv2._ensure_manager(),
                               input_keys=drv2.input_keys, key_prefix=f"r{st2.epoch}:")
        assert stream.tasks_executed == 0
        assert st2.cache.rehydrations > 0
        for rid, ps in enumerate(uniq):
            masks = [stream.outputs[i][rid]["mask"] for i in range(2)]
            assert all(isinstance(m, torch.Tensor) and m.dtype == torch.bool for m in masks)
            ys = [objective({"mask": m}, i) for i, m in enumerate(masks)]
            assert sum(ys) / 2 == st2.evaluated[ps]
    finally:
        drv2.close()
