"""The port's optimizer (``repro_torch.optim``) against the JAX package's
``repro.optim``: AdamW over five steps of a random nested tree, the
warmup-cosine schedule, and the gradient wire formats; plus the reference's
own AdamW and compression tests (``tests/test_sa_serve_and_optim.py``
``TestAdamW``, ``tests/test_elastic_and_compression.py``
``TestCompressionNumerics``), re-targeted.

Tolerances: AdamW's fp32 arithmetic is JAX's op for op, but ``sqrt``,
``pow`` and the reductions of the global norm may round in the last place
otherwise, so parameters and moments are held to 1e-6 absolute (they are of
order 1); the schedule to 1e-6 relative (its cosine); the wire formats
exactly (one cast, or one rounding and one product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro.optim.grad_compression import compress_decompress as j_compress
from repro_torch import tree as tree_mod
from repro_torch.optim import OptConfig, adamw_init, adamw_update, global_norm, schedule
from repro_torch.optim.grad_compression import compress_decompress


def _random_tree(rng):
    """A nested tree whose keys are not in sorted order, so that the leaf
    order matters."""
    return {
        "z": rng.normal(0, 1, (3, 4)).astype(np.float32),
        "a": {"w": rng.normal(0, 0.5, (5,)).astype(np.float32),
              "b": rng.normal(0, 2, (2, 2, 3)).astype(np.float32)},
        "m": rng.normal(0, 1e-3, (7,)).astype(np.float32),
    }


def _torch(tree):
    return tree_mod.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(got, want, atol):
    for g, w in zip(tree_mod.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


class TestAdamW:
    def test_converges_on_quadratic(self):
        params = {"x": torch.tensor([3.0, -2.0])}
        state = adamw_init(params)
        cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
        loss = lambda p: torch.sum(torch.square(p["x"]))
        for _ in range(150):
            x = params["x"].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss({"x": x}), [x])
            params, state, _ = adamw_update({"x": g}, state, params, cfg)
        assert float(loss(params)) < 1e-2

    def test_clipping_and_metrics(self):
        params = {"x": torch.ones(3)}
        state = adamw_init(params)
        cfg = OptConfig(clip_norm=0.5)
        g = {"x": torch.full((3,), 100.0)}
        _, _, metrics = adamw_update(g, state, params, cfg)
        assert float(metrics["grad_norm"]) > 100.0
        assert float(metrics["lr"]) >= 0.0

    def test_init_state(self):
        params = {"b": torch.ones(2, 3), "a": torch.zeros(4, dtype=torch.bfloat16)}
        state = adamw_init(params)
        assert state["count"].dtype == torch.int32 and int(state["count"]) == 0
        for part in ("m", "v"):
            assert list(state[part]) == ["b", "a"]
            assert all(t.dtype == torch.float32 and not t.any() for t in state[part].values())
        assert state["m"]["b"].shape == (2, 3) and state["v"]["a"].shape == (4,)


@pytest.mark.parametrize("clip_norm", [1.0, 50.0])
def test_adamw_matches_jax_over_five_steps(clip_norm):
    rng = np.random.default_rng(0)
    p0 = _random_tree(rng)
    grads = [_random_tree(rng) for _ in range(5)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip_norm)
    jp, js = _jax(p0), jadamw.adamw_init(_jax(p0))
    tp = _torch(p0)
    ts = adamw_init(tp)
    for g in grads:
        jp, js, jm = jadamw.adamw_update(_jax(g), js, jp, JOptConfig(**kw))
        tp, ts, tm = adamw_update(_torch(g), ts, tp, OptConfig(**kw))
        _assert_trees_close(tp, jp, 1e-6)
        _assert_trees_close(ts["m"], js["m"], 1e-6)
        _assert_trees_close(ts["v"], js["v"], 1e-6)
        assert int(ts["count"]) == int(js["count"])
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert list(tp) == list(p0)  # the caller's key order is kept


def test_global_norm_matches_jax():
    tree = _random_tree(np.random.default_rng(3))
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jadamw.global_norm(_jax(tree))), rtol=1e-6)


@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=3, total_steps=20, min_lr_ratio=0.0),
                                 dict(warmup_steps=0, total_steps=7, lr=1.0)])
def test_schedule_matches_jax(cfg):
    total = cfg.get("total_steps", OptConfig().total_steps)
    steps = np.unique(np.linspace(0, total, 41).astype(np.int32))
    jcfg, tcfg = JOptConfig(**cfg), OptConfig(**cfg)
    for step in steps:
        want = float(jadamw.schedule(jcfg, jnp.int32(step)))
        got = float(schedule(tcfg, torch.tensor(int(step), dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scheme", ["bf16", "int8"])
def test_compress_decompress_matches_jax(scheme):
    rng = np.random.default_rng(5)
    g = rng.normal(0, 1e-2, (1024,)).astype(np.float32)
    g[:8] = [0.0, 1.5, -1.5, 2.5, -0.5, 0.5, 127.0, -127.0]  # halves: rounding to even
    want = np.asarray(j_compress(jnp.asarray(g), scheme))
    got = compress_decompress(torch.from_numpy(g), scheme).numpy()
    np.testing.assert_array_equal(got, want)


def test_compress_decompress_rejects_unknown_scheme():
    with pytest.raises(ValueError):
        compress_decompress(torch.ones(2), "fp8")


class TestCompressionNumerics:
    def test_bf16_roundtrip_error_small(self):
        rng = np.random.default_rng(0)
        g = torch.from_numpy(rng.normal(0, 1e-2, (256,)).astype(np.float32))
        out = compress_decompress(g, "bf16")
        assert float(torch.max(torch.abs(out - g))) < 1e-4

    def test_int8_relative_error_bounded(self):
        rng = np.random.default_rng(1)
        g = torch.from_numpy(rng.normal(0, 1.0, (512,)).astype(np.float32))
        out = compress_decompress(g, "int8")
        scale = float(torch.max(torch.abs(g))) / 127.0
        assert float(torch.max(torch.abs(out - g))) <= scale * 0.5 + 1e-6
