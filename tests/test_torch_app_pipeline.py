"""The reference's tests/test_app_pipeline.py re-targeted at ``repro_torch``
(the import root renamed; the JAX arrays are torch tensors and the studies
run on ``device="cpu"``).

Integration tests: the pathology workflow + SA study driver.

The critical invariant (paper §II-B): computation reuse is an optimization,
never an approximation — every strategy must produce identical Dice vectors.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.app import TABLE1_SPACE, synthetic_tile
from repro_torch.app import ops
from repro_torch.app import run_study as _run_study
from repro_torch.app.pipeline import build_workflow
from repro_torch.core import halton_sequence, moat_indices, morris_trajectories
from repro_torch.core.params import ParamSpace
from repro_torch.engine import ClusterSpec, execute_plan, plan_study

run_study = functools.partial(_run_study, device="cpu")

H = W = 64


@pytest.fixture(scope="module")
def tile():
    return synthetic_tile(H, W, seed=3)


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
def param_sets():
    pts = halton_sequence(12, SMALL_SPACE.dim)
    return SMALL_SPACE.quantise(pts)


class TestOps:
    def test_background_mask(self, tile):
        fg = ops.background_mask(torch.from_numpy(tile), 230.0, 230.0, 230.0)
        # glass band at the top must be background
        assert float(fg[: H // 8].float().mean()) < 0.2
        assert float(fg[H // 2 :].float().mean()) > 0.8

    def test_area_filter_removes_small(self):
        m = torch.zeros((32, 32), dtype=torch.bool)
        m[2:4, 2:4] = True
        m[10:20, 10:20] = True
        out = ops.area_filter(m, 10, 1000)
        assert not bool(out[2, 2]) and bool(out[15, 15])

    def test_fill_holes(self):
        m = torch.zeros((16, 16), dtype=torch.bool)
        m[4:12, 4:12] = True
        m[7:9, 7:9] = False
        out = ops.fill_holes(m, conn=4)
        assert bool(out[7, 7]) and not bool(out[0, 0])

    def test_label_components_two_blobs(self):
        m = torch.zeros((16, 16), dtype=torch.bool)
        m[2:5, 2:5] = True
        m[10:13, 10:13] = True
        lab = ops.label_components(m, conn=8)
        l1, l2 = int(lab[3, 3]), int(lab[11, 11])
        assert l1 != l2 and l1 >= 0 and l2 >= 0
        assert int(lab[0, 0]) == -1
        sizes = ops.component_sizes(lab)
        assert int(sizes[3, 3]) == 9 and int(sizes[0, 0]) == 0

    def test_watershed_splits_touching_blobs(self):
        m = np.zeros((24, 40), bool)
        yy, xx = np.mgrid[0:24, 0:40]
        m |= (yy - 12) ** 2 + (xx - 13) ** 2 < 64
        m |= (yy - 12) ** 2 + (xx - 27) ** 2 < 64
        out = ops.watershed_split(torch.from_numpy(m), 5, conn=8)
        lab = ops.label_components(out, conn=8)
        n_comp = len({int(v) for v in np.unique(np.asarray(lab)) if v >= 0})
        assert n_comp >= 2  # split line separates the two discs


class TestStudy:
    def test_strategies_agree_exactly(self, tile, param_sets):
        base = run_study(tile, param_sets, strategy="none")
        for strat, kw in [
            ("stage", {}),
            ("rtma", {"max_bucket_size": 4}),
            ("rmsr", {"active_paths": 2}),
        ]:
            out = run_study(tile, param_sets, strategy=strat, **kw)
            np.testing.assert_allclose(out["dice"], base["dice"], atol=0, rtol=0)

    def test_reuse_reduces_task_count(self, tile, param_sets):
        none = run_study(tile, param_sets, strategy="none")
        stage = run_study(tile, param_sets, strategy="stage")
        rmsr = run_study(tile, param_sets, strategy="rmsr")
        assert none["tasks_executed"] == none["tasks_total"]
        assert stage["tasks_executed"] <= none["tasks_executed"]
        assert rmsr["tasks_executed"] <= stage["tasks_executed"]
        assert rmsr["reuse_fraction"] > 0.0

    def test_dice_in_range_and_default_is_one(self, tile):
        ref = TABLE1_SPACE.default()
        out = run_study(tile, [ref], strategy="none")
        assert out["dice"][0] == pytest.approx(1.0)

    def test_engine_acceptance_64_sets(self, tile):
        """For ≥64 param sets, hybrid's planned peak_bytes
        ≤ rtma's at equal bucket size, hybrid's tasks_executed ≤ the
        per-bucket RTMA count, and execute_plan outputs are bit-identical
        across the three policies and across n_workers ∈ {1, 4}."""
        h, w = tile.shape[:2]
        wf = build_workflow(h, w)
        pts = halton_sequence(64, SMALL_SPACE.dim)
        sets = SMALL_SPACE.quantise(pts)
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
                    rid: np.asarray(out["mask"]) for rid, out in res.outputs.items()
                }
        base = masks[("rtma", 1)]
        assert set(base) == set(range(64))
        for key, got in masks.items():
            for rid in range(64):
                np.testing.assert_array_equal(got[rid], base[rid], err_msg=str((key, rid)))

    def test_moat_end_to_end(self, tile):
        """MOAT screening over a reduced space; reuse must be high because
        consecutive MOAT runs differ in a single parameter."""
        small = SMALL_SPACE
        sets, moves = morris_trajectories(small, 2, seed=1)
        out = run_study(tile, sets, strategy="rmsr")
        res = moat_indices(small, out["dice"], moves)
        assert set(res.mu_star) == set(small.names)
        assert all(v >= 0 for v in res.mu_star.values())
        assert out["reuse_fraction"] > 0.3  # MOAT shares long prefixes
