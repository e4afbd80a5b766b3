"""The port's Zamba2 (the ``hybrid`` family: Mamba2 layers and one shared
attention+MLP block) against the JAX package's on the CPU, with the JAX
parameters carried over by ``params_from_jax``.

Tolerances, and why:
- RoPE is equal; a module's bf16 output (the dense FFN, the causal conv,
  a Mamba2 block, blocked and decode attention) is within one bf16
  rounding of JAX's, its fp32 recurrence state within the scan's bar of
  2e-4;
- the model is held to the JAX package's functions run op by op
  (``jax.disable_jit()``), which round every bf16 operation as the port
  does. Compiled, XLA's CPU code leaves out some of those roundings (it
  folds a convert to bf16 and back, as after the causal conv's last sum:
  test_causal_conv_compiled), and random weights amplify such a difference
  over the layers: the compiled JAX prefill is 4-7% away from the same
  prefill run op by op in its states. So prefill and decode logits are
  held to 0.05 absolute and cached states to 3% relative in norm against
  the op-by-op JAX model, as for RWKV-6 (test_torch_models.py), and the
  port is held no further from the compiled JAX model than the op-by-op
  JAX model is;
- the serve study (reduced, op by op): equal plan counts, generated ids
  and accept rates, thresholds in gaps between the confidences
  (test_torch_sa_serve.py).
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
from repro_torch.models import decode_step, init_cache, init_params, params_from_jax, prefill
from repro_torch.models import attention as tattn, layers as tlayers, model as tmodel
from repro_torch.models import ssm as tssm

LOGIT_ATOL = 0.05
STATE_REL = 0.03
BF16_ULP = 2 ** -7  # one bf16 rounding, relative
GEN_LEN, MAX_LEN = 4, 20
PENALTIES, TOP_KS = (1.0, 1.3), (4, 16)
ARCH = "zamba2_2p7b"


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import attention as jattn, layers as jlayers, model as jmodel
    from repro.models import ssm as jssm

    cfg = jconfigs.reduced_config(jconfigs.get_config(ARCH))
    params = jmodel.init_params(cfg, jax.random.key(1))
    return dict(jax=jax, jnp=jnp, configs=jconfigs, cfg=cfg, params=params, ssm=jssm,
                attn=jattn, layers=jlayers, model=jmodel)


@pytest.fixture(scope="module")
def port(jx):
    cfg = tconfigs.reduced_config(tconfigs.get_config(ARCH))
    return cfg, params_from_jax(jx["jax"].tree.map(np.asarray, jx["params"]), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mamba_layer(tree, sb, j):
    return {k: v[sb][j] for k, v in tree["mamba"].items()}


def _bf16_close(got, want):
    """Within one bf16 rounding of the value, or of the output's scale where
    a sum cancels (one bf16 operand rounded to the other neighbour)."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP,
                               atol=BF16_ULP * float(np.abs(_np(want)).max()) / 2)


@contextlib.contextmanager
def _op_by_op(jax):
    """JAX's functions run op by op, in every thread (the serve study's
    tasks run on the engine's worker threads, where a thread-local
    ``jax.disable_jit()`` would not reach)."""
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", False)


@pytest.fixture(scope="module")
def hidden():
    return np.random.default_rng(3).normal(0, 1, (2, 24, 128)).astype(np.float32)


# -- parameters and caches ------------------------------------------------


def test_params_from_jax_keys_shapes_dtypes(jx, port):
    _, params = port
    flat_j, flat_t = _flat(jx["params"]), _flat(params)
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        leaf = k.rsplit(".", 1)[-1]
        want = torch.bfloat16 if leaf in tmodel.BF16_WEIGHTS else torch.float32
        assert flat_t[k].dtype == want, k
    # the bf16 set names no fp32 leaf of either ported family
    rwkv = jx["model"].init_params(jx["configs"].reduced_config(jx["configs"].get_config(
        "rwkv6_1p6b")), jx["jax"].random.key(0))
    for tree in (rwkv, jx["params"]):
        for k, v in _flat(tree).items():
            if k.rsplit(".", 1)[-1] in tmodel.BF16_WEIGHTS:
                assert v.ndim >= 2, k  # a matrix or stacked matrices, never a vector


def test_init_params_shapes_match_params_from_jax(port):
    cfg, ported = port
    a, b = _flat(init_params(cfg, 0, device="cpu")), _flat(ported)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_cache_matches_jax(jx, reduced):
    jcfg = jx["configs"].get_config(ARCH)
    tcfg = tconfigs.get_config(ARCH)
    if reduced:
        jcfg, tcfg = jx["configs"].reduced_config(jcfg), tconfigs.reduced_config(tcfg)
    want = _flat(jx["jax"].eval_shape(lambda: jx["model"].init_cache(jcfg, 1, 4112)))
    got = _flat(init_cache(tcfg, 1, 4112, device="meta"))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).endswith(str(want[k].dtype)), k
    if not reduced:
        assert sum(t.numel() * t.element_size() for t in got.values()) == 451_399_680


def test_full_width_parameter_count(jx):
    """2,422,359,200 parameters at full width (the config's formula says
    2,421,378,560: it counts the Mamba2 layers otherwise); shapes only."""
    jcfg = jx["configs"].get_config(ARCH)
    tree = jx["jax"].eval_shape(lambda: jx["model"].init_params(jcfg, jx["jax"].random.key(0)))
    assert sum(int(np.prod(v.shape)) for v in _flat(tree).values()) == 2_422_359_200
    assert tconfigs.get_config(ARCH).param_count() == jcfg.param_count() == 2_421_378_560


# -- modules ----------------------------------------------------------------


def test_apply_rope(jx):
    x = np.random.default_rng(0).normal(0, 1, (2, 24, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 29), (2, 24)).copy()
    for jdt, tdt in ((jx["jnp"].float32, torch.float32), (jx["jnp"].bfloat16, torch.bfloat16)):
        want = jx["layers"].apply_rope(jx["jnp"].asarray(x).astype(jdt), jx["jnp"].asarray(pos), 1e4)
        got = tlayers.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 1e4)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_dense_ffn(jx, port, hidden):
    _, params = port
    jnp = jx["jnp"]
    sj, st = jx["params"]["shared_attn"], params["shared_attn"]
    want = jx["layers"].dense_ffn(jnp.asarray(hidden).astype(jnp.bfloat16), sj["w_gate"],
                                  sj["w_up"], sj["w_down"])
    got = tlayers.dense_ffn(torch.from_numpy(hidden).to(torch.bfloat16), st["w_gate"],
                            st["w_up"], st["w_down"])
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
def test_causal_conv(jx, port, carry):
    """Op by op the taps round as JAX's do: equal."""
    _, params = port
    jnp = jx["jnp"]
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (2, 24, 256)).astype(np.float32)
    prev = rng.normal(0, 2, (2, 3, 256)).astype(np.float32) if carry else None
    bf = lambda a: None if a is None else jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: None if a is None else torch.from_numpy(a).to(torch.bfloat16)
    w = jx["params"]["mamba"]["conv_w"][0][0]
    yj, cj = jx["ssm"]._causal_conv(bf(x), w.astype(jnp.bfloat16), bf(prev))
    yt, ct = tssm._causal_conv(tb(x), params["mamba"]["conv_w"][0][0], tb(prev))
    np.testing.assert_array_equal(_np(yt), _np(yj))
    np.testing.assert_array_equal(_np(ct), _np(cj))


def test_causal_conv_compiled(jx, port):
    """Compiled, XLA keeps the last tap's sum in fp32 before the SiLU (it
    folds the convert to bf16 and back): within one bf16 rounding."""
    _, params = port
    jnp = jx["jnp"]
    x = np.random.default_rng(4).normal(0, 2, (2, 24, 256)).astype(np.float32)
    w = jx["params"]["mamba"]["conv_w"][0][0].astype(jnp.bfloat16)
    yj, _ = jx["jax"].jit(jx["ssm"]._causal_conv)(jnp.asarray(x).astype(jnp.bfloat16), w)
    yt, _ = tssm._causal_conv(torch.from_numpy(x).to(torch.bfloat16), params["mamba"]["conv_w"][0][0])
    _bf16_close(yt, yj)


def test_mamba2_block(jx, port, hidden):
    cfg, params = port
    jnp = jx["jnp"]
    xj = jnp.asarray(hidden).astype(jnp.bfloat16)
    xt = torch.from_numpy(hidden).to(torch.bfloat16)
    for sb, j in itertools.product(range(2), range(3)):
        yj, cj = jx["ssm"].mamba2_block(xj, _mamba_layer(jx["params"], sb, j), jx["cfg"],
                                        return_cache=True)
        yt, ct = tssm.mamba2_block(xt, _mamba_layer(params, sb, j), cfg, return_cache=True)
        assert yt.dtype == torch.bfloat16 and ct["state"].dtype == torch.float32
        _bf16_close(yt, yj)
        np.testing.assert_allclose(_np(ct["state"]), _np(cj["state"]), rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(_np(ct["conv"]), _np(cj["conv"]))


def test_mamba2_decode(jx, port, hidden):
    """One decode step of every layer from the same cache; the given cache
    is kept."""
    cfg, params = port
    jnp = jx["jnp"]
    rng = np.random.default_rng(6)
    state = rng.normal(0, 1, (2, 8, 16, 32)).astype(np.float32)
    conv = rng.normal(0, 1, (2, 3, 256)).astype(np.float32)
    x1 = hidden[:, :1]
    for sb, j in itertools.product(range(2), range(3)):
        cj = {"state": jnp.asarray(state), "conv": jnp.asarray(conv).astype(jnp.bfloat16)}
        ct = {"state": torch.from_numpy(state), "conv": torch.from_numpy(conv).to(torch.bfloat16)}
        yj, nj = jx["ssm"].mamba2_decode(jnp.asarray(x1).astype(jnp.bfloat16),
                                         _mamba_layer(jx["params"], sb, j), jx["cfg"], cj)
        yt, nt = tssm.mamba2_decode(torch.from_numpy(x1).to(torch.bfloat16),
                                    _mamba_layer(params, sb, j), cfg, ct)
        np.testing.assert_allclose(_np(nt["state"]), _np(nj["state"]), rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(_np(nt["conv"]), _np(nj["conv"]))
        _bf16_close(yt, yj)
        assert torch.equal(ct["state"], torch.from_numpy(state))


@pytest.mark.parametrize("window,q_offset,prefix_len,kv", [
    (24, 0, 0, 4), (8, 0, 0, 4), (24, 0, 0, 2), (100, 40, 0, 2), (6, 0, 5, 4),
    (24, 0, 16, 1), (8, 0, 12, 2), (10, 0, 20, 4),
])
def test_blocked_attention(jx, window, q_offset, prefix_len, kv):
    """The CPU path runs JAX's streaming softmax over key chunks (chunk 16
    of 24 keys: a padded last chunk)."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(window + kv)
    q = rng.normal(0, 1, (2, 24, 4, 32)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 24, kv, 32)).astype(np.float32) for _ in range(2))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        kw = dict(window=window, q_offset=q_offset, prefix_len=prefix_len, chunk=16)
        want = jx["attn"].blocked_attention(*[jnp.asarray(a).astype(jdt) for a in (q, k, v)], **kw)
        got = tattn.blocked_attention(*[torch.from_numpy(a).to(tdt) for a in (q, k, v)], **kw)
        assert got.dtype == tdt
        _bf16_close(got, want)


def test_decode_attention(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (2, 1, 4, 32)).astype(np.float32)
    kc, vc = (rng.normal(0, 1, (2, 20, 2, 32)).astype(np.float32) for _ in range(2))
    for window in (2**30, 5):
        want = jx["attn"].decode_attention(
            *[jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kc, vc)], 13, window=window)
        got = tattn.decode_attention(
            *[torch.from_numpy(a).to(torch.bfloat16) for a in (q, kc, vc)], 13, window=window)
        assert got.dtype == torch.bfloat16
        _bf16_close(got, want)


# -- the model ------------------------------------------------------------


@pytest.fixture(scope="module")
def prompt():
    """One prompt of the serve study's shape: op by op, JAX compiles each
    operation once a shape, so the study below reuses this warm-up."""
    return np.random.default_rng(5).integers(0, 512, (1, 16)).astype(np.int32)


@pytest.fixture(scope="module")
def prefilled(jx, port, prompt):
    """The same prompt through JAX's prefill op by op and compiled, and
    through the port's: {name: (logits, cache)}."""
    cfg, params = port
    jax, jnp = jx["jax"], jx["jnp"]
    batch = {"tokens": jnp.asarray(prompt)}
    with _op_by_op(jax):
        el, ec, en = jx["model"].prefill(jx["cfg"], jx["params"], batch, max_len=MAX_LEN)
    cl, cc, _ = jx["model"].prefill(jx["cfg"], jx["params"], batch, max_len=MAX_LEN)
    tl, tc, tn = prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, max_len=MAX_LEN)
    assert en == tn == prompt.shape[1]
    return {"op_by_op": (el, ec), "compiled": (cl, cc), "port": (tl, tc)}


def test_prefill_logits_and_cache(prefilled):
    (jl, jc), (tl, tc) = prefilled["op_by_op"], prefilled["port"]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL)
    assert int(np.argmax(_np(tl)[0])) == int(np.argmax(_np(jl)[0]))
    fj, ft = _flat(jc), _flat(tc)
    assert ft.keys() == fj.keys() == {"mamba.state", "mamba.conv", "k", "v"}
    for k in fj:
        assert tuple(ft[k].shape) == fj[k].shape and str(ft[k].dtype).endswith(str(fj[k].dtype)), k
        assert _rel(ft[k], fj[k]) < STATE_REL, k
    # the positions past the prompt stay zero
    assert not ft["k"][:, :, 16:].any() and not ft["v"][:, :, 16:].any()


def test_prefill_no_further_from_compiled_jax_than_jax_itself(prefilled):
    (el, ec), (cl, cc), (tl, tc) = (prefilled[k] for k in ("op_by_op", "compiled", "port"))
    fe, fc, ft = _flat(ec), _flat(cc), _flat(tc)
    for k in fc:
        assert _rel(ft[k], fc[k]) <= 1.25 * _rel(fe[k], fc[k]) + 1e-3, k
    own = float(np.abs(_np(el) - _np(cl)).max())
    assert float(np.abs(_np(tl) - _np(cl)).max()) <= 1.25 * own + 2 ** -8


def test_decode_step_teacher_forced(jx, port, prefilled, prompt):
    """Three steps fed the same tokens, each package from its own prefill
    cache, JAX op by op; the port's input cache is kept."""
    cfg, params = port
    jax, jnp = jx["jax"], jx["jnp"]
    (_, jc), (_, tc) = prefilled["op_by_op"], prefilled["port"]
    kept = {k: v.clone() for k, v in _flat(tc).items()}
    n = prompt.shape[1]
    for i, tok in enumerate(np.random.default_rng(7).integers(0, 512, (3, 1, 1)).astype(np.int32)):
        with _op_by_op(jax):
            jl, jc = jx["model"].decode_step(jx["cfg"], jx["params"], {"tokens": jnp.asarray(tok)},
                                             jc, jnp.int32(n + i))
        tl, tc = decode_step(cfg, params, {"tokens": torch.from_numpy(tok)}, tc, n + i)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL)
        fj, ft = _flat(jc), _flat(tc)
        for k in fj:
            assert _rel(ft[k], fj[k]) < STATE_REL, (i, k)
    for k, v in _flat(prefilled["port"][1]).items():
        assert torch.equal(v, kept[k]), k


# -- the serve study ------------------------------------------------------


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
def study(jx, port):
    from repro.core.sa_serve import build_serve_stage as jbuild, run_sa_serve as jrun

    jax = jx["jax"]
    cfg, params = port
    rng = np.random.default_rng(1)
    prompts = {p: rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32) for p in range(2)}
    jstage = jbuild(jx["cfg"], jx["params"], prompts, gen_len=GEN_LEN, max_len=MAX_LEN)
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
        jout = jrun(jx["cfg"], jx["params"], prompts, sets, gen_len=GEN_LEN, max_len=MAX_LEN,
                    hbm_budget_bytes=budget)
    tout = tserve.run_sa_serve(cfg, params, prompts, sets, gen_len=GEN_LEN, max_len=MAX_LEN,
                               hbm_budget_bytes=3 * tstage.tasks[0].output_bytes)
    return dict(sets=sets, jstage=jstage, tstage=tstage, generated=generated,
                thresholds=thresholds, jout=jout, tout=tout, budget=budget)


def test_serve_plan_counts_equal_jax(study):
    jout, tout = study["jout"], study["tout"]
    js, ts = study["jstage"], study["tstage"]
    for jt, tt in zip(js.tasks, ts.tasks, strict=True):
        assert (tt.name, tt.param_names, tt.cost, tt.output_bytes) == (
            jt.name, jt.param_names, jt.cost, jt.output_bytes)
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
        np.testing.assert_allclose(tconf, jconf, rtol=0.05, atol=0)
    trates = study["tout"]["accept_rate"]
    assert trates == study["jout"]["accept_rate"]
    assert len(set(trates.values())) > 1
    for th in study["thresholds"]:
        rates = [r for rid, r in trates.items() if dict(study["sets"][rid])["threshold"] == th]
        assert 0.0 < np.mean(rates) < 1.0, th


def test_prefill_output_is_not_modified_by_generate(study):
    """A prefill's cache (Mamba2 states, conv carries, keys and values) is
    shared by every generate under it."""
    stage = study["tstage"]
    state = stage.tasks[0].fn({}, prompt_id=0)
    before = {k: v.clone() for k, v in _flat(state["cache"]).items()}
    stage.tasks[1].fn(state, rep_penalty=1.3, top_k=4)
    for k, v in _flat(state["cache"]).items():
        assert torch.equal(v, before[k]), k


def test_full_width_plan_equals_jax():
    """The full Zamba2 2.7B stage (3 prompts of 4096 tokens, 16 generated,
    36 sets at a budget of three caches) plans as in the JAX package,
    without building the model: the counts chip_smoke.py checks."""
    from repro.configs import get_config
    from repro.core.sa_serve import build_serve_stage as jbuild
    from repro.core.workflow import Workflow as JWorkflow
    from repro.engine import ClusterSpec as JCluster, MemoryBudget as JMemory
    from repro.engine import plan_study as jplan

    prompts = {p: np.zeros((1, 4096), np.int32) for p in range(3)}
    sets = _grid(3, (1e-4, 2e-4, 3e-4))
    tstage = tserve.build_serve_stage(tconfigs.get_config(ARCH),
                                      {"embed": torch.empty(0, device="meta")}, prompts,
                                      gen_len=16, max_len=4112)
    jstage = jbuild(get_config(ARCH), None, prompts, gen_len=16, max_len=4112)
    cache_b = tstage.tasks[0].output_bytes
    assert cache_b == jstage.tasks[0].output_bytes == 451_399_680
    tplan = plan_study(Workflow(stages=(tstage,)), sets, memory=MemoryBudget(bytes=3 * cache_b),
                       cluster=ClusterSpec(n_workers=1), policy="rmsr")
    jplan_ = jplan(JWorkflow(stages=(jstage,)), sets, memory=JMemory(bytes=3 * cache_b),
                   cluster=JCluster(n_workers=1), policy="rmsr")
    got = (tplan.tasks_total, tplan.tasks_executed, tplan.reuse_fraction, tplan.active_paths,
           tplan.peak_bytes)
    assert got == (jplan_.tasks_total, jplan_.tasks_executed, jplan_.reuse_fraction,
                   jplan_.active_paths, jplan_.peak_bytes)
    assert got == (108, 51, 57 / 108, 2, 1_015_649_408)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_card_blocked_attention_runs_the_kernel(card):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 40, 4, 32)).astype(np.float32))
               .to(card, torch.bfloat16) for _ in range(3))
    before, simt = fa.WGMMA_LAUNCHES.value, fa.LAUNCHES.value
    got = tattn.blocked_attention(q, k, v, window=40)
    # bf16 with D = 32: the tensor-core kernel
    assert fa.WGMMA_LAUNCHES.value == before + 1 and fa.LAUNCHES.value == simt
    want = tattn.blocked_attention(q.cpu(), k.cpu(), v.cpu(), window=40)
    # both round p to bf16; the CPU path also rounds q·scale to bf16
    np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=2 ** -6, atol=2 ** -7)
    # a prefix-LM call (PaliGemma's image prefix) takes the tensor-core kernel too
    before, simt = fa.WGMMA_LAUNCHES.value, fa.LAUNCHES.value
    got = tattn.blocked_attention(q, k, v, window=16, prefix_len=24)
    assert fa.WGMMA_LAUNCHES.value == before + 1 and fa.LAUNCHES.value == simt
    want = tattn.blocked_attention(q.cpu(), k.cpu(), v.cpu(), window=16, prefix_len=24)
    # both round p to bf16; the CPU path also rounds q·scale to bf16
    np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.gpu
def test_card_reduced_model_matches_cpu(card):
    cfg = tconfigs.reduced_config(tconfigs.get_config(ARCH))
    cpu_params = init_params(cfg, 0, device="cpu")
    card_params = {k: ({kk: vv.to(card) for kk, vv in v.items()} if isinstance(v, dict)
                       else v.to(card)) for k, v in cpu_params.items()}
    toks = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(0, 512, (1, 16)))}
    lc, cc, _ = prefill(cfg, card_params, toks, max_len=20)
    lp, cp, _ = prefill(cfg, cpu_params, toks, max_len=20)
    np.testing.assert_allclose(_np(lc.cpu()), _np(lp), rtol=0, atol=LOGIT_ATOL)
    fc, fp = _flat(cc), _flat(cp)
    for k in fp:
        assert _rel(fc[k].cpu(), fp[k]) < STATE_REL, k
