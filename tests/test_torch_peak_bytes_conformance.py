"""The reference's tests/test_peak_bytes_conformance.py re-targeted at
``repro_torch`` (the import root renamed; the study generator is
``test_torch_study_gen``).

Empirical check of the §2 AOT liveness proof (DESIGN.md §2).

A plan's ``schedule.peak_bytes`` is advertised as a *proof* about any
executor that replays the frozen order with the liveness rule (a node's
buffer becomes live when it executes, a parent dies with its last executed
child, leaves are emitted immediately). This suite replays random
rmsr/rtma/hybrid schedules while instrumenting exactly that rule and
asserts the observed live-byte high-water mark never exceeds the proven
``peak_bytes`` — the AOT bound, checked against an actual execution trace.
"""

import random

import pytest

from repro_torch.core.rmsr import replay_schedule
from repro_torch.engine import plan_study

from test_torch_study_gen import random_param_sets, random_workflow


def replay_with_live_bytes(bucket, input_state):
    """Replay the bucket's frozen schedule while tracking live bytes under
    the executor's own liveness rule; returns (outputs, observed peak)."""
    tree, order = bucket.tree, bucket.schedule.order
    live = {}
    remaining = {}
    cur = peak = 0
    trace = []

    for node in order:
        task = tree.stage.tasks[node.depth]
        nbytes = task.bound_bytes(dict(node.instances[0].params))
        live[node.uid] = nbytes
        cur += nbytes
        peak = max(peak, cur)
        trace.append(cur)
        if node.is_leaf:
            cur -= live.pop(node.uid)  # emitted immediately
        else:
            remaining[node.uid] = len(node.children)
        parent = node.parent
        if parent is not None and parent.depth >= 0:
            remaining[parent.uid] -= 1
            if remaining[parent.uid] == 0:
                cur -= live.pop(parent.uid)  # parent dies with last child

    assert cur == 0, "liveness leak: buffers still live after replay"
    outputs, _, _ = replay_schedule(tree, order, input_state)
    return outputs, peak


@pytest.mark.parametrize("seed", range(12))
def test_observed_live_bytes_never_exceed_proof(seed):
    rng = random.Random(4200 + seed)
    wf, names, cards = random_workflow(rng, max_bytes=512)
    sets = random_param_sets(rng, names, cards, rng.randint(2, 28))
    checked = 0
    for pol in ("rtma", "rmsr", "hybrid"):
        plan = plan_study(
            wf,
            sets,
            policy=pol,
            max_bucket_size=rng.choice([2, 3, None]),
            active_paths=rng.choice([1, 2, 3, None]),
        )
        for stage_plan in plan.stages:
            for bucket in stage_plan.buckets:
                _, observed = replay_with_live_bytes(bucket, 7)
                assert observed <= bucket.schedule.peak_bytes, (
                    pol,
                    stage_plan.stage.name,
                    observed,
                    bucket.schedule.peak_bytes,
                )
                checked += 1
    assert checked > 0


def test_instrumentation_is_not_vacuous():
    """The tracker must actually observe nonzero live bytes on a workflow
    with nonzero buffers (guards against a trivially-passing instrument)."""
    rng = random.Random(1)
    while True:
        wf, names, cards = random_workflow(rng, max_bytes=512)
        if any(t.output_bytes for s in wf.stages for t in s.tasks):
            break
    sets = random_param_sets(rng, names, cards, 8)
    plan = plan_study(wf, sets, policy="rmsr", active_paths=2)
    peaks = [
        replay_with_live_bytes(b, 3)[1]
        for sp in plan.stages
        for b in sp.buckets
    ]
    assert any(p > 0 for p in peaks)


def test_plan_peak_respects_memory_budget_end_to_end():
    """Budget-solved plans: the observed live peak of every bucket must fit
    the schedule budget the planner solved against."""
    from repro_torch.engine import MemoryBudget

    rng = random.Random(99)
    wf, names, cards = random_workflow(rng, max_bytes=512)
    sets = random_param_sets(rng, names, cards, 24)
    budget = MemoryBudget(bytes=8 * 512)
    for pol in ("rtma", "rmsr", "hybrid"):
        plan = plan_study(wf, sets, policy=pol, memory=budget)
        for sp in plan.stages:
            for bucket in sp.buckets:
                _, observed = replay_with_live_bytes(bucket, 11)
                assert observed <= budget.schedule_bytes, (pol, sp.stage.name)
