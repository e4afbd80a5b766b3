"""The port's configs and RWKV-6 model against the JAX package's on the CPU,
with the JAX parameters carried over by ``params_from_jax``.

Tolerances, and why:
- the configs are equal;
- ``rms_norm`` in fp32 is within two fp32 ulps (its mean sums in another
  order), and in bf16 within one bf16 rounding of that;
- a block's bf16 output may differ by one bf16 rounding: the scan's fp32
  sums run in another order (within 2e-4, test_torch_ssm_scan.py), and the
  two libraries may round an fp32 value next to a rounding boundary (a
  tanh, a product) to either neighbour. The recurrence states, fp32, are
  held to the scan's bar of 2e-4: the decay passes through such a bf16
  tanh;
- after several layers those single roundings grow, because random weights
  amplify a change of one input ulp: prefill and decode logits are held to
  0.05 absolute (logits here are below 1, where a bf16 ulp is 2^-8 to 2^-9),
  and cached states to 3% relative in norm.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import decode_step, init_cache, init_params, params_from_jax, prefill
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import rms_norm

LOGIT_ATOL = 0.05
STATE_REL = 0.03


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import decode_step as jdecode, init_params, prefill as jprefill
    from repro.models import ssm as jssm
    from repro.models.layers import rms_norm as jrms

    cfg = jconfigs.reduced_config(jconfigs.get_config("rwkv6_1p6b"))
    params = init_params(cfg, jax.random.key(1))
    return dict(jax=jax, jnp=jnp, configs=jconfigs, cfg=cfg, params=params, ssm=jssm,
                rms=jrms, prefill=jprefill, decode=jdecode)


@pytest.fixture(scope="module")
def port(jx):
    cfg = tconfigs.reduced_config(tconfigs.get_config("rwkv6_1p6b"))
    params = params_from_jax(jx["jax"].tree.map(np.asarray, jx["params"]), "cpu")
    return cfg, params


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(5).integers(0, 512, (2, 12)).astype(np.int32)


@pytest.fixture(scope="module")
def prefilled(jx, port, prompt):
    """Both packages' prefill of the same prompt: (JAX logits, JAX cache,
    port logits, port cache)."""
    cfg, params = port
    jl, jc, jn = jx["prefill"](jx["cfg"], jx["params"], {"tokens": jx["jnp"].asarray(prompt)},
                               max_len=16)
    tl, tc, tn = prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, max_len=16)
    assert jn == tn == prompt.shape[1]
    return jl, jc, tl, tc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _layer(tree, i):
    return {k: v[i] for k, v in tree["layers"].items()}


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_configs_equal_jax(jx, arch):
    jc = jx["configs"]
    assert tconfigs.ARCH_IDS == jc.ARCH_IDS
    full_t, full_j = tconfigs.get_config(arch), jc.get_config(arch)
    for t, j in ((full_t, full_j), (tconfigs.reduced_config(full_t), jc.reduced_config(full_j))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.padded_vocab, t.ssm_heads, t.layer_kinds()) == (j.padded_vocab, j.ssm_heads, j.layer_kinds())
    assert tconfigs.supports_long_context(full_t) == jc.supports_long_context(full_j)


def test_full_rwkv6_sizes():
    cfg = tconfigs.get_config("rwkv6_1p6b")
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_ff,
            cfg.padded_vocab) == (24, 2048, 32, 64, 7168, 65536)
    assert cfg.param_count() == 1_728_153_600
    cache = init_cache(cfg, 1, 1040, device="meta")
    assert sum(t.numel() * t.element_size() for t in cache.values()) == 12_779_520


def test_params_from_jax_keys_shapes_dtypes(jx, port):
    _, params = port
    flat_j = {k: v for k, v in jx["params"].items() if k != "layers"}
    assert set(params) == set(jx["params"])
    assert set(params["layers"]) == set(jx["params"]["layers"])
    for k, v in {**flat_j, **jx["params"]["layers"]}.items():
        t = params[k] if k in flat_j else params["layers"][k]
        assert tuple(t.shape) == v.shape, k
        assert t.dtype == (torch.bfloat16 if k in {"embed", "lm_head"} or
                           (k.startswith("w_") and k != "w_lora_b") else torch.float32), k


def test_init_params_shapes_match_params_from_jax(port):
    cfg, ported = port
    params = init_params(cfg, 0, device="cpu")
    flat = lambda p: {**{k: v for k, v in p.items() if k != "layers"},
                      **{"layers." + k: v for k, v in p["layers"].items()}}
    a, b = flat(params), flat(ported)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ["gemma3_1b", "granite_moe_1b_a400m", "paligemma_3b",
                                  "musicgen_medium"])
def test_transformer_families_match_jax_trees(jx, arch):
    """The dense, moe, vlm and audio families build what JAX's
    ``init_params`` and ``init_cache`` build: the same keys and shapes, and
    JAX's dtypes for the cache; the parameters are fp32 in JAX and held in
    bf16 by the port exactly for the leaves of ``BF16_WEIGHTS``."""
    from repro.models import init_cache as jcache, init_params as jparams

    from repro_torch.models import model as tmodel

    jax = jx["jax"]
    jcfg = jx["configs"].reduced_config(jx["configs"].get_config(arch))
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    assert cfg.family in ("dense", "moe", "vlm", "audio")
    want = _flat(jax.eval_shape(lambda: jparams(jcfg, jax.random.key(0))))
    got = _flat(init_params(cfg, 0, device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        leaf = k.rsplit(".", 1)[-1]
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == (torch.bfloat16 if leaf in tmodel.BF16_WEIGHTS else torch.float32)
    want = _flat(jax.eval_shape(lambda: jcache(jcfg, 1, 8)))
    got = _flat(init_cache(cfg, 1, 8, device="cpu"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and str(got[k].dtype).endswith(str(v.dtype)), k


def test_unknown_family_raises_value_error():
    """As in the JAX package: a family no model builds is a ValueError."""
    cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("granite_3_8b")),
                              family="diffusion")
    for build in (lambda: init_params(cfg, 0, device="cpu"),
                  lambda: init_cache(cfg, 1, 8, device="cpu"),
                  lambda: prefill(cfg, {}, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, 8)):
        with pytest.raises(ValueError, match="diffusion"):
            build()


def test_rms_norm(jx, port):
    _, params = port
    x = np.random.default_rng(0).normal(0, 2, (2, 7, 128)).astype(np.float32)
    scale = jx["params"]["layers"]["ln1"][0]
    for dt_j, dt_t in ((jx["jnp"].float32, torch.float32), (jx["jnp"].bfloat16, torch.bfloat16)):
        want = jx["rms"](jx["jnp"].asarray(x).astype(dt_j), scale, 1e-5)
        got = rms_norm(torch.from_numpy(x).to(dt_t), params["layers"]["ln1"][0], 1e-5)
        assert got.dtype == dt_t
        tol = 2.5e-7 if dt_t == torch.float32 else 2 ** -8
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=0)


@pytest.fixture(scope="module")
def hidden():
    return np.random.default_rng(3).normal(0, 1, (2, 24, 128)).astype(np.float32)


def test_rwkv6_block(jx, port, hidden):
    cfg, params = port
    jnp = jx["jnp"]
    xj = jnp.asarray(hidden).astype(jnp.bfloat16)
    xt = torch.from_numpy(hidden).to(torch.bfloat16)
    for i in range(cfg.num_layers):
        yj, hj = jx["ssm"].rwkv6_block(xj, _layer(jx["params"], i), jx["cfg"], return_state=True)
        yt, ht = tssm.rwkv6_block(xt, _layer(params, i), cfg, return_state=True)
        assert yt.dtype == torch.bfloat16 and ht.dtype == torch.float32
        np.testing.assert_allclose(_np(ht), _np(hj), rtol=2e-4, atol=2e-4)
        # at most one bf16 rounding apart (2^-7 relative)
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=2 ** -7, atol=2 ** -9)


def test_rwkv6_channel_mix(jx, port, hidden):
    cfg, params = port
    jnp = jx["jnp"]
    prev = np.random.default_rng(4).normal(0, 1, (2, 128)).astype(np.float32)
    for i in range(cfg.num_layers):
        yj, lj = jx["ssm"].rwkv6_channel_mix(
            jnp.asarray(hidden).astype(jnp.bfloat16), _layer(jx["params"], i),
            prev=jnp.asarray(prev).astype(jnp.bfloat16))
        yt, lt = tssm.rwkv6_channel_mix(
            torch.from_numpy(hidden).to(torch.bfloat16), _layer(params, i),
            prev=torch.from_numpy(prev).to(torch.bfloat16))
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=2 ** -7, atol=2 ** -9)
        np.testing.assert_array_equal(_np(lt), _np(lj))


def test_rwkv6_decode(jx, port, hidden):
    """One decode step of every layer from the same cache."""
    cfg, params = port
    jnp = jx["jnp"]
    rng = np.random.default_rng(6)
    state = rng.normal(0, 1, (2, 4, 32, 32)).astype(np.float32)
    tm = rng.normal(0, 1, (2, 128)).astype(np.float32)
    x1 = hidden[:, :1]
    for i in range(cfg.num_layers):
        cj = {"state": jnp.asarray(state), "tm_prev": jnp.asarray(tm).astype(jnp.bfloat16),
              "cm_prev": jnp.asarray(tm).astype(jnp.bfloat16)}
        ct = {"state": torch.from_numpy(state), "tm_prev": torch.from_numpy(tm).to(torch.bfloat16),
              "cm_prev": torch.from_numpy(tm).to(torch.bfloat16)}
        yj, nj = jx["ssm"].rwkv6_decode(jnp.asarray(x1).astype(jnp.bfloat16),
                                       _layer(jx["params"], i), jx["cfg"], cj)
        yt, nt = tssm.rwkv6_decode(torch.from_numpy(x1).to(torch.bfloat16), _layer(params, i), cfg, ct)
        np.testing.assert_allclose(_np(nt["state"]), _np(nj["state"]), rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(_np(nt["tm_prev"]), _np(nj["tm_prev"]))
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=2 ** -7, atol=2 ** -9)
        assert torch.equal(ct["state"], torch.from_numpy(state))  # the given cache is kept


def test_prefill_logits_and_cache(prefilled):
    jl, jc, tl, tc = prefilled
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL)
    assert int(np.argmax(_np(tl)[0])) == int(np.argmax(_np(jl)[0]))
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and str(tc[k].dtype).endswith(str(jc[k].dtype)), k
        assert _rel(tc[k], jc[k]) < STATE_REL, k


def test_decode_step_teacher_forced(jx, port, prefilled, prompt):
    """Three steps fed the same tokens: each package from its own prefill
    cache, and the port also from JAX's cache (one step's own error)."""
    cfg, params = port
    jnp = jx["jnp"]
    _, jc, _, tc = prefilled
    tc_from_j = {k: torch.from_numpy(_np(v)).to(tc[k].dtype) for k, v in jc.items()}
    n = prompt.shape[1]
    for i, tok in enumerate(np.random.default_rng(7).integers(0, 512, (3, 2, 1)).astype(np.int32)):
        jl, jc = jx["decode"](jx["cfg"], jx["params"], {"tokens": jnp.asarray(tok)}, jc, jnp.int32(n + i))
        tl, tc = decode_step(cfg, params, {"tokens": torch.from_numpy(tok)}, tc, n + i)
        tl1, tc_from_j = decode_step(cfg, params, {"tokens": torch.from_numpy(tok)}, tc_from_j, n + i)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(_np(tl1), _np(jl), rtol=0, atol=LOGIT_ATOL)
        assert _rel(tc["state"], jc["state"]) < STATE_REL
