"""The port's planner and metrics against the JAX package's, on the same
inputs: plan counts must be equal and Dice/Jaccard exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.app.pipeline import TABLE1_SPACE as J_SPACE, build_workflow as j_workflow
from repro.core import dice as j_dice, jaccard as j_jaccard, moat_indices as j_moat
from repro.core import halton_sequence as j_halton, morris_trajectories as j_morris
from repro.engine import MemoryBudget as JBudget, plan_study as j_plan

from repro_torch.app.pipeline import TABLE1_SPACE as T_SPACE, build_workflow as t_workflow
from repro_torch.core import dice as t_dice, jaccard as t_jaccard, moat_indices as t_moat
from repro_torch.core import halton_sequence as t_halton, morris_trajectories as t_morris
from repro_torch.engine import MemoryBudget as TBudget, plan_study as t_plan

POLICIES = ("none", "stage", "rtma", "rmsr", "hybrid")
PLAN_FIELDS = ("tasks_total", "tasks_executed", "peak_bytes", "reuse_fraction", "active_paths")


def _sets(kind):
    """The same parameter sets, drawn through each package's own samplers."""
    if kind == "moat4096":
        return 4096, j_morris(J_SPACE, 1, seed=0)[0], t_morris(T_SPACE, 1, seed=0)[0]
    if kind == "halton64":
        return (
            64,
            J_SPACE.quantise(j_halton(32, J_SPACE.dim)),
            T_SPACE.quantise(t_halton(32, T_SPACE.dim)),
        )
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["moat4096", "halton64"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("budget", [None, 256 << 20])
def test_plan_counts_equal(kind, policy, budget):
    size, j_sets, t_sets = _sets(kind)
    assert j_sets == t_sets
    kw = {"policy": policy}
    if budget is None:
        kw["active_paths"] = 4
    jp = j_plan(j_workflow(size, size), j_sets, memory=JBudget(bytes=budget), **kw)
    tp = t_plan(t_workflow(size, size), t_sets, memory=TBudget(bytes=budget), **kw)
    for field in PLAN_FIELDS:
        assert getattr(tp, field) == getattr(jp, field), field


def test_headline_plan_4096():
    """The 4096² MOAT study of the on-card smoke run: 16 runs, 128 tasks,
    71 executed, 1.19 GiB planned peak, reuse 0.445."""
    sets, _ = t_morris(T_SPACE, 1, seed=0)
    plan = t_plan(t_workflow(4096, 4096), sets, policy="rmsr", active_paths=4)
    assert len(sets) == 16
    assert (plan.tasks_total, plan.tasks_executed) == (128, 71)
    assert plan.peak_bytes == int(1.1875 * 2**30)
    assert plan.reuse_fraction == 0.4453125


def test_moat_indices_equal():
    j_sets, j_moves = j_morris(J_SPACE, 2, seed=4)
    t_sets, t_moves = t_morris(T_SPACE, 2, seed=4)
    assert (j_sets, j_moves) == (t_sets, t_moves)
    outputs = list(np.random.default_rng(4).uniform(0, 1, len(j_sets)))
    jr, tr = j_moat(J_SPACE, outputs, j_moves), t_moat(T_SPACE, outputs, t_moves)
    assert jr.mu_star == tr.mu_star and jr.sigma == tr.sigma


def _masks(seed, shape, p):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape) < p, rng.uniform(size=shape) < p


@pytest.mark.parametrize(
    "seed,shape,p",
    [(0, (64, 64), 0.3), (1, (17, 5), 0.5), (2, (128, 96), 0.02), (3, (8, 8), 0.0)],
)
@pytest.mark.parametrize("metric", ["dice", "jaccard"])
def test_metrics_exact(seed, shape, p, metric):
    """Exact on random masks; p=0 is the both-empty case (1.0 by rule)."""
    a, b = _masks(seed, shape, p)
    jf, tf = {"dice": (j_dice, t_dice), "jaccard": (j_jaccard, t_jaccard)}[metric]
    for x, y in [(a, b), (a, np.zeros_like(b)), (np.zeros_like(a), np.zeros_like(b))]:
        want = float(jf(jnp.asarray(x), jnp.asarray(y)))
        got = tf(torch.from_numpy(x), torch.from_numpy(y))
        assert got.dtype == torch.float32
        assert float(got) == want
