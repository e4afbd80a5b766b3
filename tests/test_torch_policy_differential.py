"""The reference's tests/test_policy_differential.py re-targeted at
``repro_torch`` (the import root renamed; the study generator is
``test_torch_study_gen``).

Differential/property harness for the whole policy matrix.

The contract under test is the engine's strongest claim: for ANY workflow,
ANY parameter sets and ANY input, all five policies (`none`/`stage`/`rtma`/
`rmsr`/`hybrid`), both executors (`execute_plan` and `execute_study`) and
every worker count produce **bit-identical** per-run outputs equal to the
straight-line no-reuse oracle — while the reuse policies never execute more
tasks than the `stage` baseline, and `execute_study` starts exactly ONE
Manager session per study (vs one per input for sequential execution).

Random cases come from the seeded generator in ``test_torch_study_gen`` so the suite
is deterministic without hypothesis; when hypothesis is installed an extra
shrinkable property layer drives the same checks (derandomized under CI via
conftest's "ci" profile).
"""

import random

import pytest

from repro_torch.engine import ClusterSpec, execute_plan, execute_study, plan_study
from repro_torch.engine.types import POLICIES
from repro_torch.runtime.manager import Manager

from test_torch_study_gen import naive_outputs, random_param_sets, random_workflow

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False


def _random_case(seed: int):
    rng = random.Random(seed)
    wf, names, cards = random_workflow(rng)
    sets = random_param_sets(rng, names, cards, rng.randint(1, 24))
    inputs = [rng.randrange(1 << 40) for _ in range(rng.randint(1, 4))]
    plan_kwargs = {
        "max_bucket_size": rng.choice([1, 2, 3, None]),
        "active_paths": rng.choice([1, 2, None]),
    }
    return wf, sets, inputs, plan_kwargs


def _check_case(wf, sets, inputs, plan_kwargs, workers=(1, 3)):
    oracles = [naive_outputs(wf, sets, x) for x in inputs]
    stage_plan = plan_study(wf, sets, policy="stage")
    for pol in POLICIES:
        plan = plan_study(wf, sets, policy=pol, **plan_kwargs)
        if pol in ("rtma", "rmsr", "hybrid"):
            # reuse never does MORE work than the coarse-dedup baseline
            assert plan.tasks_executed <= stage_plan.tasks_executed, pol
        assert plan.tasks_executed <= plan.tasks_total
        for w in workers:
            cluster = ClusterSpec(n_workers=w)
            for i, x in enumerate(inputs):
                res = execute_plan(plan, x, cluster=cluster)
                assert res.outputs == oracles[i], (pol, w, i)

            before = Manager.sessions_started
            stream = execute_study(plan, inputs, cluster=cluster)
            # one persistent session per study, not one per stage×input
            assert Manager.sessions_started - before == 1, (pol, w)
            assert stream.manager_sessions == 1
            for i in range(len(inputs)):
                assert stream.outputs[i] == oracles[i], (pol, w, i)
                assert stream.per_input[i].outputs == oracles[i]
            # accounting: executed + cache hits covers every planned task,
            # for every input, with nothing double-counted
            assert (
                stream.tasks_executed + stream.cache_hits
                == plan.tasks_executed * len(inputs)
            ), (pol, w)


@pytest.mark.parametrize("seed", range(10))
def test_differential_policy_matrix(seed):
    wf, sets, inputs, plan_kwargs = _random_case(9000 + seed)
    _check_case(wf, sets, inputs, plan_kwargs)


def test_reuse_policies_never_exceed_stage_baseline_work():
    """Task-count ordering across the matrix, on a batch of random cases:
    none == total ≥ stage ≥ rtma == hybrid ≥ rmsr."""
    for seed in range(25):
        rng = random.Random(5000 + seed)
        wf, names, cards = random_workflow(rng)
        sets = random_param_sets(rng, names, cards, rng.randint(2, 32))
        plans = {
            pol: plan_study(wf, sets, policy=pol, max_bucket_size=4, active_paths=2)
            for pol in POLICIES
        }
        assert plans["none"].tasks_executed == plans["none"].tasks_total
        assert plans["stage"].tasks_executed <= plans["none"].tasks_executed
        assert plans["rtma"].tasks_executed <= plans["stage"].tasks_executed
        assert plans["hybrid"].tasks_executed == plans["rtma"].tasks_executed
        assert plans["rmsr"].tasks_executed <= plans["rtma"].tasks_executed


def test_study_of_one_input_equals_execute_plan_accounting():
    wf, sets, inputs, plan_kwargs = _random_case(77)
    plan = plan_study(wf, sets, policy="hybrid", **plan_kwargs)
    res = execute_plan(plan, inputs[0])
    stream = execute_study(plan, [inputs[0]])
    assert stream.outputs[0] == res.outputs
    assert stream.tasks_executed == res.tasks_executed
    assert stream.cache_hits == res.cache_hits
    assert stream.per_input[0].per_stage_executed == res.per_stage_executed


def test_cross_input_cache_isolation():
    """Two different inputs through one cached (hybrid) study: the
    input-scoped cache segment must keep their merged prefixes apart even
    when every parameter agrees — a collision would surface as input B
    receiving input A's outputs."""
    rng = random.Random(31337)
    wf, names, cards = random_workflow(rng, max_stages=2)
    sets = random_param_sets(rng, names, cards, 12)
    inputs = [1, 2]  # adjacent ints: identical params, different input
    stream = execute_study(plan_study(wf, sets, policy="hybrid"), inputs)
    for i, x in enumerate(inputs):
        assert stream.outputs[i] == naive_outputs(wf, sets, x), i
    assert stream.outputs[0] != stream.outputs[1]


if HAVE_HYPOTHESIS:

    class TestHypothesisDifferential:
        @given(
            seed=st.integers(min_value=0, max_value=2**20),
            n_runs=st.integers(min_value=1, max_value=16),
            n_inputs=st.integers(min_value=1, max_value=3),
            workers=st.sampled_from([1, 2, 4]),
        )
        @settings(max_examples=15, deadline=None)
        def test_policy_matrix_bit_identical(self, seed, n_runs, n_inputs, workers):
            rng = random.Random(seed)
            wf, names, cards = random_workflow(rng)
            sets = random_param_sets(rng, names, cards, n_runs)
            inputs = [rng.randrange(1 << 40) for _ in range(n_inputs)]
            plan_kwargs = {
                "max_bucket_size": rng.choice([1, 2, None]),
                "active_paths": rng.choice([1, 2, None]),
            }
            _check_case(wf, sets, inputs, plan_kwargs, workers=(workers,))
