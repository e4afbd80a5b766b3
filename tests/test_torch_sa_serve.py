"""The port's SA-over-serving study against the JAX package's on the CPU:
the reduced RWKV-6 with the JAX parameters carried over, the same prompts
and the same parameter grid.

Plan counts, cache bytes, generated ids and accept rates are equal.
Confidences are held to 5% relative: they are softmax values of logits that
differ by a few bf16 roundings (test_torch_models.py), and exp of a 0.05
logit difference is 5%. The thresholds are placed in gaps between the
confidences that both packages produce, so that every accept rate compares
values on the same side of its threshold and is neither all 0 nor all 1.
"""

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


@pytest.fixture(scope="module")
def study():
    import jax

    from repro.configs import get_config, reduced_config
    from repro.core.sa_serve import build_serve_stage as jbuild, run_sa_serve as jrun
    from repro.models import init_params

    jcfg = reduced_config(get_config("rwkv6_1p6b"))
    jparams = init_params(jcfg, jax.random.key(1))
    cfg = tconfigs.reduced_config(tconfigs.get_config("rwkv6_1p6b"))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    prompts = {p: rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32) for p in range(2)}

    # one generate per (prompt, penalty): top_k changes no token (first
    # maximal index in both packages)
    jstage = jbuild(jcfg, jparams, prompts, gen_len=GEN_LEN, max_len=MAX_LEN)
    tstage = tserve.build_serve_stage(cfg, params, prompts, gen_len=GEN_LEN, max_len=MAX_LEN)
    generated = {}
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
    jbudget = 3 * jstage.tasks[0].output_bytes
    jout = jrun(jcfg, jparams, prompts, sets, gen_len=GEN_LEN, max_len=MAX_LEN,
                hbm_budget_bytes=jbudget)
    tout = tserve.run_sa_serve(cfg, params, prompts, sets, gen_len=GEN_LEN, max_len=MAX_LEN,
                               hbm_budget_bytes=3 * tstage.tasks[0].output_bytes)
    return dict(cfg=cfg, params=params, prompts=prompts, sets=sets, jstage=jstage,
                tstage=tstage, generated=generated, thresholds=thresholds, jout=jout,
                tout=tout, jbudget=jbudget)


def test_stage_matches_jax(study):
    js, ts = study["jstage"], study["tstage"]
    assert ts.name == js.name
    for jt, tt in zip(js.tasks, ts.tasks, strict=True):
        assert (tt.name, tt.param_names, tt.cost, tt.output_bytes) == (
            jt.name, jt.param_names, jt.cost, jt.output_bytes)


def test_plan_counts_equal_jax(study):
    jout, tout = study["jout"], study["tout"]
    n = len(study["sets"])
    assert tout["tasks_total"] == jout["tasks_total"] == 3 * n
    # 2 prefills, 2 × 2 × 2 generates, every score
    assert tout["tasks_executed"] == jout["tasks_executed"] == 2 + 8 + n
    for key in ("planned_tasks_executed", "reuse_fraction", "active_paths", "peak_bytes",
                "cache_hits"):
        assert tout[key] == jout[key], key
    assert tout["peak_bytes"] <= study["jbudget"]


def test_generated_ids_equal_and_confidences_close(study):
    for (p, rp), (jids, jconf, tids, tconf) in study["generated"].items():
        assert tids.dtype == np.int64 and tids.shape == jids.shape == (1, GEN_LEN)
        np.testing.assert_array_equal(tids, jids, err_msg=f"prompt {p}, penalty {rp}")
        np.testing.assert_allclose(tconf, jconf, rtol=CONF_RTOL, atol=0)


def test_accept_rates_equal_and_not_vacuous(study):
    jrates, trates = study["jout"]["accept_rate"], study["tout"]["accept_rate"]
    assert trates == jrates
    assert len(set(trates.values())) > 1
    for th in study["thresholds"]:
        rates = [r for rid, r in trates.items() if dict(study["sets"][rid])["threshold"] == th]
        assert 0.0 < np.mean(rates) < 1.0, th


def test_reused_equals_naive(study):
    """Reuse must not change results: each set run on its own through the
    stage's tasks gives the accept rate the merged study gave."""
    for rid, ps in enumerate(study["sets"]):
        state, d = {}, dict(ps)
        for t in study["tstage"].tasks:
            state = t.fn(state, **{k: d[k] for k in t.param_names})
        assert study["tout"]["accept_rate"][rid] == float(state["accept_rate"])


def test_prefill_output_is_not_modified_by_generate(study):
    """A prefill's cache is shared by every generate under it."""
    stage = study["tstage"]
    state = stage.tasks[0].fn({}, prompt_id=0)
    before = {k: v.clone() for k, v in state["cache"].items()}
    stage.tasks[1].fn(state, rep_penalty=1.3, top_k=4)
    for k, v in before.items():
        assert torch.equal(state["cache"][k], v)


def test_full_width_plan_equals_jax():
    """The full RWKV-6 1.6B stage (3 prompts of 1024 tokens, 16 generated,
    36 sets at a budget of three caches) plans as in the JAX package,
    without building the model."""
    from repro.configs import get_config
    from repro.core.sa_serve import build_serve_stage as jbuild
    from repro.core.workflow import Workflow as JWorkflow
    from repro.engine import ClusterSpec as JCluster, MemoryBudget as JMemory
    from repro.engine import plan_study as jplan

    prompts = {p: np.zeros((1, 1024), np.int32) for p in range(3)}
    sets = [
        tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": k, "threshold": th}.items()))
        for p, rp, k, th in itertools.product(range(3), (1.0, 1.3), (4, 16), (1e-4, 2e-4, 3e-4))
    ]
    cfg = tconfigs.get_config("rwkv6_1p6b")
    tstage = tserve.build_serve_stage(cfg, {"embed": torch.empty(0, device="meta")}, prompts,
                                      gen_len=16, max_len=1040)
    jstage = jbuild(get_config("rwkv6_1p6b"), None, prompts, gen_len=16, max_len=1040)
    cache_b = tstage.tasks[0].output_bytes
    assert cache_b == jstage.tasks[0].output_bytes == 12_779_520
    tplan = plan_study(Workflow(stages=(tstage,)), sets, memory=MemoryBudget(bytes=3 * cache_b),
                       cluster=ClusterSpec(n_workers=1), policy="rmsr")
    jplan_ = jplan(JWorkflow(stages=(jstage,)), sets, memory=JMemory(bytes=3 * cache_b),
                   cluster=JCluster(n_workers=1), policy="rmsr")
    got = (tplan.tasks_total, tplan.tasks_executed, tplan.reuse_fraction, tplan.active_paths,
           tplan.peak_bytes)
    assert got == (jplan_.tasks_total, jplan_.tasks_executed, jplan_.reuse_fraction,
                   jplan_.active_paths, jplan_.peak_bytes)
    assert got == (108, 51, 57 / 108, 2, 28_754_048)
