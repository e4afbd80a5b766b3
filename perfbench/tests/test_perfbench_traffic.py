"""The traffic generators: determinism by seed, the frozen copies against
the program as it stood when they were made, and the task counts that the
pathology cells' designs give the program's planner."""

import numpy as np
import pytest

from perfbench.traffic import inputs, params


def test_inputs_repeat_by_seed_and_differ_across_seeds():
    pool = inputs.sub_tile_pool(2**31 + 5, 4, 16)
    again = inputs.sub_tile_pool(2**31 + 5, 4, 16)
    assert np.array_equal(pool, again)
    assert not np.array_equal(pool, inputs.sub_tile_pool(2**31 + 6, 4, 16))
    a = inputs.mosaic(pool, 9, 0, 0, 2)
    assert a.shape == (32, 32, 3) and a.dtype == np.float32
    assert np.array_equal(a, inputs.mosaic(pool, 9, 0, 0, 2))
    assert not np.array_equal(a, inputs.mosaic(pool, 9, 1, 0, 2))
    pop = list(range(50))
    assert inputs.sample(7, pop, 5) == inputs.sample(7, pop, 5) != inputs.sample(8, pop, 5)
    assert inputs.sample(7, pop[:3], 5) == pop[:3]


def test_mosaic_is_an_arrangement_of_the_pool():
    pool = inputs.sub_tile_pool(3, 4, 8)
    tile = inputs.mosaic(pool, 3, 2, 1, 2)
    blocks = [tile[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] for r in range(2) for c in range(2)]
    variants = [np.asarray(v) for p in pool for v in (p, p[::-1], p[:, ::-1], p[::-1, ::-1])]
    assert all(any(np.array_equal(b, v) for v in variants) for b in blocks)


def test_frozen_copies_equal_the_program():
    from repro_torch.app import pipeline
    from repro_torch.core import halton_sequence, morris_trajectories

    space = pipeline.TABLE1_SPACE
    assert {p.name: p.values for p in space.params} == params.TABLE1
    assert params.default_set() == space.default()
    assert params.item_sets({"design": "morris", "design_seed": 0}) == \
        morris_trajectories(space, 1, seed=0)[0]
    assert params.item_sets({"design": "halton", "points": 16, "skip": 20}) == \
        space.quantise(halton_sequence(16, space.dim, skip=20))
    rng_a, rng_b = np.random.default_rng(4), 4
    assert np.array_equal(inputs.synthetic_tile(40, 48, rng_a),
                          pipeline.synthetic_tile(40, 48, seed=rng_b))


@pytest.mark.parametrize("design,executed", [
    ({"design": "morris", "design_seed": 0}, 71),
    ({"design": "halton", "points": 16, "skip": 20}, 113),
])
def test_designs_task_counts_at_4096(design, executed):
    """Tasks a tile the planner executes (hybrid, two workers, 4096² byte
    model): MOAT's one-at-a-time moves share prefixes, Halton's points
    share normalize alone."""
    from repro_torch.app.pipeline import build_workflow
    from repro_torch.engine import ClusterSpec, MemoryBudget, plan_study

    plan = plan_study(build_workflow(4096, 4096), params.item_sets(design),
                      memory=MemoryBudget(bytes=None), cluster=ClusterSpec(n_workers=2),
                      policy="hybrid", active_paths=4)
    assert (plan.tasks_total, plan.tasks_executed) == (128, executed)


def test_every_item_carries_the_design():
    cell = {"design": "morris", "design_seed": 0}
    assert params.item_sets(cell) == params.item_sets(cell)
    with pytest.raises(ValueError):
        params.item_sets({"design": "grid"})
