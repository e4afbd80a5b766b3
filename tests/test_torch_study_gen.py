"""Seeded random study generator shared by the port's differential /
property / conformance suites (no jax, no hypothesis — plain
``random.Random``): tests/study_gen.py over ``repro_torch.core``, so that
spawned workers rebuilding a study import the port alone. The tests at the
end hold it to the reference's generator, case for case.

Workflows are multi-stage pipelines of integer-mixing tasks: each task's
output is ``(x * M + crc32(stage, task, sorted(params))) mod P`` — a
collision-sensitive pure function of ``(input, params)``, so any routing,
merging, caching or scoping bug in the engine shows up as a wrong integer,
not a tolerance miss. Bit-identical here means ``==`` on exact ints.
"""

from __future__ import annotations

import functools
import random
import time
import zlib
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.core import StageSpec, TaskSpec, Workflow

PRIME = (1 << 61) - 1
_MULT = 1048573


def _mix_task(stage_idx: int, task_idx: int, x: int, **kw) -> int:
    tag = repr((stage_idx, task_idx, tuple(sorted(kw.items())))).encode()
    return (x * _MULT + zlib.crc32(tag)) % PRIME


def _mix_fn(stage_idx: int, task_idx: int):
    return functools.partial(_mix_task, stage_idx, task_idx)


def random_workflow(
    rng: random.Random,
    *,
    max_stages: int = 3,
    max_tasks: int = 3,
    max_card: int = 3,
    max_bytes: int = 256,
) -> Tuple[Workflow, List[str], Dict[str, int]]:
    """Random multi-stage workflow. Returns (workflow, param names in order,
    name -> cardinality). Some tasks are parameter-free (the collapsing
    normalization case); byte sizes and costs vary per task."""
    names: List[str] = []
    cards: Dict[str, int] = {}
    stages: List[StageSpec] = []
    for si in range(rng.randint(1, max_stages)):
        tasks = []
        for ti in range(rng.randint(1, max_tasks)):
            n_params = rng.choice([0, 1, 1, 2])
            task_names = []
            for _ in range(n_params):
                nm = f"p{len(names)}"
                names.append(nm)
                cards[nm] = rng.randint(1, max_card)
                task_names.append(nm)
            tasks.append(
                TaskSpec(
                    name=f"s{si}t{ti}",
                    param_names=tuple(task_names),
                    fn=_mix_fn(si, ti),
                    cost=rng.choice([0.5, 1.0, 2.0]),
                    output_bytes=rng.choice([0, max_bytes // 4, max_bytes]),
                )
            )
        stages.append(StageSpec(name=f"stage{si}", tasks=tuple(tasks)))
    return Workflow(stages=tuple(stages)), names, cards


# ---------------------------------------------------------------------------
# Spawn-picklable form: a workflow described by a plain-data LAYOUT
# ---------------------------------------------------------------------------
#
# ``_mix_task`` is module-level and task fns are ``functools.partial`` over
# it, so a layout-built workflow survives pickling — which is what lets the
# WorkerBackend conformance suite rebuild the *same* workflow inside spawn
# worker processes (``mix_study_build`` is a ProcessRpcBackend ``build``).

Layout = List[List[Tuple[str, Tuple[str, ...], float, int]]]


def workflow_from_layout(layout: Layout) -> Workflow:
    """Deterministically rebuild the workflow a layout describes; two
    processes calling this with one layout hold structurally identical
    workflows computing identical integers."""
    stages = tuple(
        StageSpec(
            name=f"stage{si}",
            tasks=tuple(
                TaskSpec(
                    name=name,
                    param_names=tuple(pnames),
                    fn=_mix_fn(si, ti),
                    cost=cost,
                    output_bytes=nbytes,
                )
                for ti, (name, pnames, cost, nbytes) in enumerate(tasks)
            ),
        )
        for si, tasks in enumerate(layout)
    )
    return Workflow(stages=stages)


def random_layout(
    rng: random.Random,
    *,
    max_stages: int = 3,
    max_tasks: int = 3,
    max_card: int = 3,
    max_bytes: int = 256,
) -> Tuple[Layout, List[str], Dict[str, int]]:
    """Random layout mirroring :func:`random_workflow`'s shape distribution
    (same task/param structure; data-only, so it crosses a spawn boundary).
    """
    names: List[str] = []
    cards: Dict[str, int] = {}
    layout: Layout = []
    for _si in range(rng.randint(1, max_stages)):
        tasks = []
        for ti in range(rng.randint(1, max_tasks)):
            n_params = rng.choice([0, 1, 1, 2])
            task_names = []
            for _ in range(n_params):
                nm = f"p{len(names)}"
                names.append(nm)
                cards[nm] = rng.randint(1, max_card)
                task_names.append(nm)
            tasks.append(
                (
                    f"s{len(layout)}t{ti}",
                    tuple(task_names),
                    rng.choice([0.5, 1.0, 2.0]),
                    rng.choice([0, max_bytes // 4, max_bytes]),
                )
            )
        layout.append(tasks)
    return layout, names, cards


def mix_study_build(layout: Layout, inputs: Sequence[Any]):
    """ProcessRpcBackend ``build``: reconstruct the layout's workflow and
    inputs inside a worker process."""
    return {"workflow": workflow_from_layout(layout), "inputs": list(inputs)}


def random_param_sets(
    rng: random.Random, names: Sequence[str], cards: Dict[str, int], n_runs: int
) -> List[Tuple[Tuple[str, int], ...]]:
    """n_runs random ParamSets (duplicates likely at small cardinality —
    exactly what exercises dedup/merging)."""
    return [
        tuple((nm, rng.randrange(cards[nm])) for nm in names) for _ in range(n_runs)
    ]


# ---------------------------------------------------------------------------
# Calibration form: tasks whose wall-time EQUALS their declared cost
# ---------------------------------------------------------------------------


def _sleep_task(stage_idx: int, duration: float, x: int, **kw) -> int:
    time.sleep(duration)
    return _mix_task(stage_idx, 0, x, **kw)


def sleep_workflow(stage_costs: Sequence[float]) -> Workflow:
    """One parametric task per stage that *sleeps* its declared cost (in
    seconds) before mixing — so a plan's ``schedule.makespan`` values are
    real wall-seconds and a measured run can be compared against
    ``simulate_stream``'s prediction (the simulator-calibration suite).
    Sleeps release the GIL, so thread-Worker concurrency is real."""
    stages = tuple(
        StageSpec(
            name=f"stage{si}",
            tasks=(
                TaskSpec(
                    name=f"s{si}t0",
                    param_names=(f"sp{si}",),
                    fn=functools.partial(_sleep_task, si, cost),
                    cost=cost,
                    output_bytes=64,
                ),
            ),
        )
        for si, cost in enumerate(stage_costs)
    )
    return Workflow(stages=stages)


def naive_outputs(workflow: Workflow, param_sets, input_state):
    """The trusted oracle: every run independently, straight-line, no reuse,
    no dispatch. Anything any executor returns must equal this exactly."""
    out = {}
    for rid, ps in enumerate(param_sets):
        d = dict(ps)
        x = input_state
        for stage in workflow.stages:
            for task in stage.tasks:
                x = task.fn(x, **{k: d[k] for k in task.param_names})
        out[rid] = x
    return out


# ---------------------------------------------------------------------------
# The generator against the reference's (tests/study_gen.py): the same seeds
# give the same layouts, workflows, parameter sets and integers. The JAX
# package is imported inside the tests: spawned workers import this module
# for its task functions and must not pay for it.
# ---------------------------------------------------------------------------


def test_random_workflows_match_the_reference_generator():
    import study_gen as ref

    for seed in range(20):
        wf, names, cards = random_workflow(random.Random(seed))
        rwf, rnames, rcards = ref.random_workflow(random.Random(seed))
        assert (names, cards) == (rnames, rcards)
        shape = [[(t.name, t.param_names, t.cost, t.output_bytes) for t in s.tasks]
                 for s in wf.stages]
        rshape = [[(t.name, t.param_names, t.cost, t.output_bytes) for t in s.tasks]
                  for s in rwf.stages]
        assert shape == rshape
        rng, rrng = random.Random(seed + 100), random.Random(seed + 100)
        sets = random_param_sets(rng, names, cards, 6)
        assert sets == ref.random_param_sets(rrng, rnames, rcards, 6)
        assert naive_outputs(wf, sets, seed) == ref.naive_outputs(rwf, sets, seed)


def test_layouts_match_the_reference_generator():
    import study_gen as ref

    for seed in range(20):
        layout, names, cards = random_layout(random.Random(seed))
        assert (layout, names, cards) == ref.random_layout(random.Random(seed))
        sets = random_param_sets(random.Random(seed), names, cards, 5)
        built = mix_study_build(layout, [seed, seed + 1])
        rbuilt = ref.mix_study_build(layout, [seed, seed + 1])
        assert built["inputs"] == rbuilt["inputs"]
        for x in built["inputs"]:
            assert naive_outputs(built["workflow"], sets, x) == ref.naive_outputs(
                rbuilt["workflow"], sets, x
            )
    wf = sleep_workflow([0.0, 0.0])
    assert naive_outputs(wf, [(("sp0", 1), ("sp1", 2))], 3) == ref.naive_outputs(
        ref.sleep_workflow([0.0, 0.0]), [(("sp0", 1), ("sp1", 2))], 3
    )
