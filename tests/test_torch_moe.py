"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``moe_ffn_local`` on the CPU, run op by op, in both of its
branches: dropless (``t*k <= 4096``) and capacity-bounded with tokens
dropped to the sink row.

The router and its top-k are fp32 and must pick the same experts in the
same order, ties to the lower expert; the dispatch slots and the kept
pairs are integers and must be equal. The outputs are bf16 sums of bf16
products, whose fp32 sums run in another order: within one bf16 rounding.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.dist import make_ctx
from repro_torch.models import moe as tmoe

BF16_ULP = 2 ** -7
D, F, E = 128, 256, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bf16_close(got, want):
    """Within one bf16 rounding of the value, or of the output's scale where
    a sum cancels."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP,
                               atol=BF16_ULP * float(np.abs(_np(want)).max()) / 2)


@contextlib.contextmanager
def _op_by_op(jax):
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", False)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    return jax, jnp, jmoe


def weights(seed, e=E, router=None):
    """Router (D, E) fp32, experts (E, D, F), (E, D, F), (E, F, D) in bf16
    values, at the JAX model's init scales."""
    rng = np.random.default_rng(seed)
    rw = rng.normal(0, 0.02, (D, e)).astype(np.float32) if router is None else router
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    wg = to_bf16(rng.normal(0, D ** -0.5, (e, D, F)).astype(np.float32))
    wu = to_bf16(rng.normal(0, D ** -0.5, (e, D, F)).astype(np.float32))
    wd = to_bf16(rng.normal(0, F ** -0.5, (e, F, D)).astype(np.float32))
    return rw, wg, wu, wd


def _both(jx, x, w, k):
    """(JAX output, port output) of moe_ffn_local on bf16 tokens."""
    jax, jnp, jmoe = jx
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    with _op_by_op(jax):
        want = jmoe.moe_ffn_local(xj, *[jnp.asarray(a) for a in w], k=k)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    rw, *experts = (torch.from_numpy(a) for a in w)
    got = tmoe.moe_ffn_local(xt, rw, *[e.to(torch.bfloat16) for e in experts], k=k)
    return want, got


def _reference_routing(jx, x, rw, k, cap):
    """The reference's routing, slots and kept pairs, computed with its
    own ops (src/repro/models/moe.py: moe_ffn_local)."""
    jax, jnp, _ = jx
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    gates = jax.nn.softmax(xj.astype(jnp.float32) @ jnp.asarray(rw), axis=-1)
    gval, gidx = jax.lax.top_k(gates, k)
    gval = gval / jnp.maximum(gval.sum(-1, keepdims=True), 1e-9)
    e = rw.shape[1]
    eflat = gidx.reshape(-1)
    onehot = jax.nn.one_hot(eflat, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - 1, eflat[:, None], 1)[:, 0]
    keep = pos < cap
    slot = jnp.where(keep, eflat * cap + pos, e * cap)
    return np.asarray(gval), np.asarray(gidx), np.asarray(slot), np.asarray(keep)


def _port_routing(x, rw, k, cap):
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gval, gidx = tmoe.route(xt, torch.from_numpy(rw), k)
    slot, keep = tmoe.slots(gidx, rw.shape[1], cap)
    return gval.numpy(), gidx.numpy(), slot.numpy(), keep.numpy()


@pytest.mark.parametrize("t,k", [(1, 2), (24, 2), (48, 1), (300, 4)])
def test_dropless_matches_jax(jx, t, k):
    """t*k <= 4096: every pair has a slot (cap = t)."""
    x = np.random.default_rng(t).normal(0, 1, (t, D)).astype(np.float32)
    w = weights(t + k)
    assert tmoe.capacity(t, k, E, 1.25) == t
    g, gi, slot, keep = _port_routing(x, w[0], k, t)
    jg, jgi, jslot, jkeep = _reference_routing(jx, x, w[0], k, t)
    np.testing.assert_array_equal(gi, jgi)
    np.testing.assert_array_equal(slot, jslot)
    assert keep.all() and jkeep.all()
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-7)
    want, got = _both(jx, x, w, k)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _bf16_close(got, want)


def test_capacity_bounded_drops_match_jax(jx):
    """2100 tokens top-2 of 4 experts (t*k = 4200 > 4096): 1312 slots an
    expert. Every token leans to expert 0 (a positive offset in the tokens,
    a positive router column 0), so expert 0 overflows and the pairs past
    its 1312th, in the flattened (t, k) order, drop: the same pairs on both
    sides, and the same outputs within one bf16 rounding."""
    t, k = 2100, 2
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 1, (t, D)) + 1.0).astype(np.float32)
    rw = rng.normal(0, 0.02, (D, E)).astype(np.float32)
    rw[:, 0] += 0.05
    w = weights(1, router=rw)
    cap = tmoe.capacity(t, k, E, 1.25)
    assert cap == int(t * k / E * 1.25) == 1312
    g, gi, slot, keep = _port_routing(x, rw, k, cap)
    jg, jgi, jslot, jkeep = _reference_routing(jx, x, rw, k, cap)
    np.testing.assert_array_equal(gi, jgi)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(slot, jslot)
    assert (gi[:, 0] == 0).all()
    dropped = int((~keep).sum())
    assert dropped == t - cap  # expert 0's overflow; the other experts fit
    assert (slot[~keep] == E * cap).all()
    want, got = _both(jx, x, w, k)
    _bf16_close(got, want)


def test_top_k_ties_go_to_the_lower_expert(jx):
    """Two equal router columns give exactly equal gates: JAX's top_k takes
    the lower expert first, and so does the port's stable sort."""
    jax, jnp, _ = jx
    rng = np.random.default_rng(3)
    rw = rng.normal(0, 0.5, (D, E)).astype(np.float32)
    rw[:, 2] = rw[:, 1]
    x = rng.normal(0, 1, (64, D)).astype(np.float32)
    g, gi, _, _ = _port_routing(x, rw, 3, 64)
    jg, jgi, _, _ = _reference_routing(jx, x, rw, 3, 64)
    np.testing.assert_array_equal(gi, jgi)
    pairs = [tuple(r) for r in gi if 1 in r and 2 in r]
    assert pairs and all(r.index(1) < r.index(2) for r in pairs)


def test_full_width_capacity():
    """granite_moe_1b_a400m's 4096-token prefill: t*k = 32768 > 4096, 1280
    slots an expert; a decode step (one token) is dropless; Mixtral's 4096
    tokens top-2 of 8: 1280 too."""
    from repro_torch import configs

    g = configs.get_config("granite_moe_1b_a400m")
    assert tmoe.capacity(4096, g.experts_per_token, g.num_experts, g.moe_capacity_factor) == 1280
    assert tmoe.capacity(1, g.experts_per_token, g.num_experts, g.moe_capacity_factor) == 1
    m = configs.get_config("mixtral_8x7b")
    assert tmoe.capacity(4096, m.experts_per_token, m.num_experts, m.moe_capacity_factor) == 1280


def test_batched_moe_ffn_and_ctx():
    """moe_ffn over (B, S, D) is moe_ffn_local over the B*S tokens; a ctx
    without a mesh is one device (the mesh layouts:
    tests/test_torch_moe_sharded.py)."""
    rw, wg, wu, wd = (torch.from_numpy(a) for a in weights(5))
    p = {"router": rw, "w_gate": wg.bfloat16(), "w_up": wu.bfloat16(), "w_down": wd.bfloat16()}
    x = torch.randn(2, 12, D, generator=torch.Generator().manual_seed(0)).bfloat16()
    got = tmoe.moe_ffn(x, p, k=2)
    want = tmoe.moe_ffn_local(x.reshape(24, D), rw, p["w_gate"], p["w_up"], p["w_down"], k=2)
    assert torch.equal(got, want.reshape(2, 12, D))
    assert torch.equal(tmoe.moe_ffn(x, p, k=2, ctx=make_ctx(None, mode="serve")), got)
