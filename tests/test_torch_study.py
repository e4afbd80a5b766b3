"""The port's single-tile SA study on the CPU: Dice lists and task counts
equal to the JAX package's ``run_study`` on the same tile and parameter
sets, and the study invariants of tests/test_app_pipeline.py held against
the port."""

import numpy as np
import pytest
import torch

from repro.app import run_study as j_run_study

from repro_torch.app import TABLE1_SPACE, run_study, synthetic_tile
from repro_torch.app.pipeline import build_workflow
from repro_torch.core import halton_sequence, moat_indices, morris_trajectories
from repro_torch.core.params import ParamSpace
from repro_torch.engine import ClusterSpec, execute_plan, plan_study

H = W = 64

SMALL_SPACE = ParamSpace.from_dict(
    {
        "B": [210, 230],
        "G": [210, 230],
        "R": [210, 230],
        "T1": [2.5, 5.0],
        "T2": [2.5, 5.0],
        "G1": [20, 40],
        "G2": [10, 20],
        "minS": [2, 10],
        "maxS": [900, 1200],
        "minSPL": [5, 20],
        "minSS": [2, 10],
        "maxSS": [900, 1200],
        "FH": [4, 8],
        "RC": [4, 8],
        "WConn": [4, 8],
    }
)


@pytest.fixture(scope="module")
def tile():
    return synthetic_tile(H, W, seed=3)


@pytest.fixture(scope="module")
def param_sets():
    return SMALL_SPACE.quantise(halton_sequence(12, SMALL_SPACE.dim))


def _cpu_study(tile, sets, **kw):
    return run_study(tile, sets, device="cpu", **kw)


@pytest.mark.parametrize("strategy", ["none", "rmsr"])
def test_matches_jax_run_study(tile, param_sets, strategy):
    want = j_run_study(tile, param_sets, strategy=strategy)
    got = _cpu_study(tile, param_sets, strategy=strategy)
    assert got["dice"] == want["dice"]
    for key in ("tasks_total", "tasks_executed", "planned_tasks_executed", "reuse_fraction"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["reference_mask"], want["reference_mask"])


def test_default_device_is_the_card(tile):
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_study(tile, [TABLE1_SPACE.default()])


class TestStudy:
    def test_strategies_agree_exactly(self, tile, param_sets):
        base = _cpu_study(tile, param_sets, strategy="none")
        for strat, kw in [
            ("stage", {}),
            ("rtma", {"max_bucket_size": 4}),
            ("rmsr", {"active_paths": 2}),
        ]:
            out = _cpu_study(tile, param_sets, strategy=strat, **kw)
            np.testing.assert_allclose(out["dice"], base["dice"], atol=0, rtol=0)

    def test_reuse_reduces_task_count(self, tile, param_sets):
        none = _cpu_study(tile, param_sets, strategy="none")
        stage = _cpu_study(tile, param_sets, strategy="stage")
        rmsr = _cpu_study(tile, param_sets, strategy="rmsr")
        assert none["tasks_executed"] == none["tasks_total"]
        assert stage["tasks_executed"] <= none["tasks_executed"]
        assert rmsr["tasks_executed"] <= stage["tasks_executed"]
        assert rmsr["reuse_fraction"] > 0.0

    def test_dice_in_range_and_default_is_one(self, tile, param_sets):
        out = _cpu_study(tile, [TABLE1_SPACE.default()], strategy="none")
        assert out["dice"] == [1.0]
        out = _cpu_study(tile, param_sets)
        assert all(0.0 <= d <= 1.0 for d in out["dice"])

    def test_engine_acceptance_64_sets(self, tile):
        """For 64 sets, hybrid's planned peak_bytes ≤ rtma's at equal bucket
        size, hybrid's tasks_executed ≤ rtma's, and execute_plan outputs
        are bit-identical across the three policies and n_workers ∈ {1, 4}."""
        wf = build_workflow(H, W)
        sets = SMALL_SPACE.quantise(halton_sequence(64, SMALL_SPACE.dim))
        plans = {
            pol: plan_study(wf, sets, policy=pol, max_bucket_size=8, active_paths=2)
            for pol in ("rtma", "rmsr", "hybrid")
        }
        assert plans["hybrid"].peak_bytes <= plans["rtma"].peak_bytes
        assert plans["hybrid"].tasks_executed <= plans["rtma"].tasks_executed

        raw = {"raw": torch.from_numpy(tile)}
        masks = {}
        for pol, plan in plans.items():
            for workers in (1, 4):
                res = execute_plan(plan, raw, cluster=ClusterSpec(n_workers=workers))
                masks[(pol, workers)] = {
                    rid: out["mask"].numpy() for rid, out in res.outputs.items()
                }
        base = masks[("rtma", 1)]
        assert set(base) == set(range(64))
        for key, got in masks.items():
            for rid in range(64):
                np.testing.assert_array_equal(got[rid], base[rid], err_msg=str((key, rid)))

    def test_moat_end_to_end(self, tile):
        """MOAT screening over a reduced space; reuse must be high because
        consecutive MOAT runs differ in a single parameter."""
        sets, moves = morris_trajectories(SMALL_SPACE, 2, seed=1)
        out = _cpu_study(tile, sets, strategy="rmsr")
        res = moat_indices(SMALL_SPACE, out["dice"], moves)
        assert set(res.mu_star) == set(SMALL_SPACE.names)
        assert all(v >= 0 for v in res.mu_star.values())
        assert out["reuse_fraction"] > 0.3
