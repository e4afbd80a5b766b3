"""The SA-serve study (``core.sa_serve.run_sa_serve``) on the port's
transformer families against the JAX package's on the CPU: a reduced dense
model (granite_3_8b) and a reduced MoE (granite_moe_1b_a400m), the JAX
parameters carried over, the same prompts and grid, JAX run op by op (see
tests/test_torch_transformer.py). Plan counts, generated ids and accept
rates are equal; confidences within 5% relative, the thresholds in gaps
between them (tests/test_torch_sa_serve.py says why). Also the full-width
plans of the two studies chip_smoke.py runs on the card (gemma3_1b and
granite_moe_1b_a400m), without building either model.
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import Workflow
from repro_torch.core import sa_serve as tserve
from repro_torch.engine import ClusterSpec, MemoryBudget, plan_study
from repro_torch.models import params_from_jax

GEN_LEN, MAX_LEN = 4, 20
PENALTIES, TOP_KS = (1.0, 1.3), (4, 16)
CONF_RTOL = 0.05


def _grid(n_prompts, thresholds):
    return [
        tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": k, "threshold": th}.items()))
        for p, rp, k, th in itertools.product(range(n_prompts), PENALTIES, TOP_KS, thresholds)
    ]


def _thresholds(conf_pairs, count=3):
    """Midpoints of the widest gaps between the intervals spanned by each
    confidence of one package and its counterpart in the other."""
    spans = sorted((min(a, b), max(a, b)) for a, b in conf_pairs)
    merged = [list(spans[0])]
    for lo, hi in spans[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(merged, merged[1:])),
                  reverse=True)
    return sorted(mid for _, mid in gaps[:count])


@contextlib.contextmanager
def _op_by_op(jax):
    """In every thread: the engine's worker threads run the tasks."""
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module", params=["granite_3_8b", "granite_moe_1b_a400m"])
def study(request):
    import jax

    from repro.configs import get_config, reduced_config
    from repro.core.sa_serve import build_serve_stage as jbuild, run_sa_serve as jrun
    from repro.models import init_params

    arch = request.param
    jcfg = reduced_config(get_config(arch))
    jparams = init_params(jcfg, jax.random.key(1))
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    assert cfg.family == ("moe" if "moe" in arch else "dense")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    prompts = {p: rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32) for p in range(2)}
    jstage = jbuild(jcfg, jparams, prompts, gen_len=GEN_LEN, max_len=MAX_LEN)
    tstage = tserve.build_serve_stage(cfg, params, prompts, gen_len=GEN_LEN, max_len=MAX_LEN)
    generated = {}
    with _op_by_op(jax):
        for p in prompts:
            js, ts = jstage.tasks[0].fn({}, prompt_id=p), tstage.tasks[0].fn({}, prompt_id=p)
            for rp in PENALTIES:
                jg = jstage.tasks[1].fn(js, rep_penalty=rp, top_k=TOP_KS[0])
                tg = tstage.tasks[1].fn(ts, rep_penalty=rp, top_k=TOP_KS[0])
                generated[p, rp] = (np.asarray(jg["ids"]), np.asarray(jg["conf"]),
                                    tg["ids"].numpy(), tg["conf"].numpy())
        pairs = [pair for g in generated.values() for pair in zip(g[1].ravel(), g[3].ravel())]
        thresholds = _thresholds(pairs)
        sets = _grid(len(prompts), thresholds)
        budget = 3 * jstage.tasks[0].output_bytes
        jout = jrun(jcfg, jparams, prompts, sets, gen_len=GEN_LEN, max_len=MAX_LEN,
                    hbm_budget_bytes=budget)
    tout = tserve.run_sa_serve(cfg, params, prompts, sets, gen_len=GEN_LEN, max_len=MAX_LEN,
                               hbm_budget_bytes=3 * tstage.tasks[0].output_bytes)
    return dict(sets=sets, jstage=jstage, tstage=tstage, generated=generated,
                thresholds=thresholds, jout=jout, tout=tout, budget=budget)


def test_serve_plan_counts_equal_jax(study):
    js, ts = study["jstage"], study["tstage"]
    for jt, tt in zip(js.tasks, ts.tasks, strict=True):
        assert (tt.name, tt.param_names, tt.cost, tt.output_bytes) == (
            jt.name, jt.param_names, jt.cost, jt.output_bytes)
    jout, tout = study["jout"], study["tout"]
    n = len(study["sets"])
    assert tout["tasks_total"] == jout["tasks_total"] == 3 * n
    assert tout["tasks_executed"] == jout["tasks_executed"] == 2 + 8 + n
    for key in ("planned_tasks_executed", "reuse_fraction", "active_paths", "peak_bytes",
                "cache_hits"):
        assert tout[key] == jout[key], key
    assert tout["peak_bytes"] <= study["budget"]


def test_serve_ids_equal_and_accept_rates_equal(study):
    for (p, rp), (jids, jconf, tids, tconf) in study["generated"].items():
        assert tids.shape == jids.shape == (1, GEN_LEN)
        np.testing.assert_array_equal(tids, jids, err_msg=f"prompt {p}, penalty {rp}")
        np.testing.assert_allclose(tconf, jconf, rtol=CONF_RTOL, atol=0)
    trates = study["tout"]["accept_rate"]
    assert trates == study["jout"]["accept_rate"]
    assert len(set(trates.values())) > 1
    for th in study["thresholds"]:
        rates = [r for rid, r in trates.items() if dict(study["sets"][rid])["threshold"] == th]
        assert 0.0 < np.mean(rates) < 1.0, th


def test_prefill_output_is_not_modified_by_generate(study):
    """A prefill's keys and values are shared by every generate under it."""
    stage = study["tstage"]
    state = stage.tasks[0].fn({}, prompt_id=0)
    before = {k: v.clone() for k, v in _flat(state["cache"]).items()}
    stage.tasks[1].fn(state, rep_penalty=1.3, top_k=4)
    for k, v in _flat(state["cache"]).items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch,cache_bytes,peak_bytes", [
    ("gemma3_1b", 109_477_888, 246_325_376),
    ("granite_moe_1b_a400m", 202_113_024, 454_754_432),
])
def test_full_width_plan_equals_jax(arch, cache_bytes, peak_bytes):
    """The full-width stage (3 prompts of 4096 tokens, 16 generated, 36
    sets at a budget of three caches) plans as in the JAX package: the
    counts chip_smoke.py checks."""
    from repro.configs import get_config
    from repro.core.sa_serve import build_serve_stage as jbuild
    from repro.core.workflow import Workflow as JWorkflow
    from repro.engine import ClusterSpec as JCluster, MemoryBudget as JMemory
    from repro.engine import plan_study as jplan

    prompts = {p: np.zeros((1, 4096), np.int32) for p in range(3)}
    sets = _grid(3, (1e-4, 2e-4, 3e-4))
    tstage = tserve.build_serve_stage(tconfigs.get_config(arch),
                                      {"embed": torch.empty(0, device="meta")}, prompts,
                                      gen_len=16, max_len=4112)
    jstage = jbuild(get_config(arch), None, prompts, gen_len=16, max_len=4112)
    cache_b = tstage.tasks[0].output_bytes
    assert cache_b == jstage.tasks[0].output_bytes == cache_bytes
    tplan = plan_study(Workflow(stages=(tstage,)), sets, memory=MemoryBudget(bytes=3 * cache_b),
                       cluster=ClusterSpec(n_workers=1), policy="rmsr")
    jplan_ = jplan(JWorkflow(stages=(jstage,)), sets, memory=JMemory(bytes=3 * cache_b),
                   cluster=JCluster(n_workers=1), policy="rmsr")
    got = (tplan.tasks_total, tplan.tasks_executed, tplan.reuse_fraction, tplan.active_paths,
           tplan.peak_bytes)
    assert got == (jplan_.tasks_total, jplan_.tasks_executed, jplan_.reuse_fraction,
                   jplan_.active_paths, jplan_.peak_bytes)
    assert got == (108, 51, 57 / 108, 2, peak_bytes)
