"""The port's transformer on meshes of more than one rank, over gloo ranks
on the CPU: training and serving on a 4×2 and a 2×2 (data, model) mesh
against the port's one-device result (``ctx=None``) and the JAX package's.

Four reduced configs: yi_6b (GQA, 4 q heads on 2 kv heads, both split over
'model'), gemma3_1b (one kv head, which 'model' does not divide: each rank
takes the kv head of its q heads), yi_6b with 6 q heads on 3 kv heads (the
groups cut across the 'model' split) and granite_moe_1b_a400m (the MoE's
train and serve layouts). All four on the 4×2 mesh; yi_6b and the MoE on
the 2×2 one too (its 'model' split is the 4×2 one's, on half the
data-parallel ranks).

Training: ``forward_train``'s loss and every gradient leaf, then one
``make_train_step``: its loss, ``grad_norm`` and updated leaves, against
``ctx=None``, and the loss, gradients and their norm against JAX's
``value_and_grad`` (op by op, as ``tests/test_torch_train.py`` runs it;
``tests/test_torch_train_step.py`` holds ``ctx=None``'s step to JAX's). A
gradient counted once a data-parallel rank is 2–4 times too large and
fails the gradient checks (AdamW's first update is nearly its gradient's
sign, so the updated leaves alone could not see it). Serving: ``prefill``
and 3 ``decode_step`` calls, logits and every cache leaf against
``ctx=None``, with the caches laid out by ``cache_shardings`` as
``make_prefill_step`` lays them out.

Tolerances: against JAX, those of ``tests/test_torch_train.py`` (loss 1e-3
absolute, each gradient leaf and ``grad_norm`` 2e-2 relative). Against
``ctx=None``: the loss 1e-5 relative (the ranks' fp32 sums in another
order); each gradient leaf 2e-2 relative (the data-parallel ranks' bf16
gradients of the bf16 weights are summed across ranks, and the
column-parallel products' activation gradients across 'model': 0.2–1.5%
here); ``grad_norm`` 5e-3 relative; each updated element within twice the
learning rate plus the weight decay's 0.1·lr·|p| (the bound of
``tests/test_torch_train_step.py``); logits and caches within 1e-2 of
their largest magnitude for the dense configs (bit-equal here but for one
decode step's logits, 0.24%: a batch row of one takes another CPU product)
and 5e-2 for the MoE, whose serve layout sums its tensor-parallel bf16
partials, as JAX's does (the tolerance of ``tests/test_moe_sharded.py``).
JAX is imported in the tests only: the spawned ranks import this module.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_train import GRAD_REL, LOSS_ATOL, _op_by_op
from torch_dist_ranks import run_ranks

B, S, MAX_LEN, DECODES = 4, 16, 24, 3

CONFIGS = {
    "yi_6b": ("yi_6b", {}),
    "gemma3_1b": ("gemma3_1b", {}),
    "yi_6b_h6_kv3": ("yi_6b", {"num_heads": 6, "num_kv_heads": 3}),
    "granite_moe_1b_a400m": ("granite_moe_1b_a400m", {}),
}


def _cfg(name, configs):
    arch, over = CONFIGS[name]
    return dataclasses.replace(configs.reduced_config(configs.get_config(arch)), **over)


def _batch(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _params(params_npz):
    from repro_torch.models import params_from_jax

    tree = {}
    for key, value in np.load(params_npz).items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return params_from_jax(tree, "cpu", masters=True)


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float().numpy()


def _port_run(name, params, ctx):
    """The port's numbers on ``ctx`` (None: one device): the loss and
    gradients of ``forward_train``, one train step, a prefill and decode
    steps. ``params``: fp32 masters, laid out for ``ctx`` by the caller."""
    from repro_torch import configs, tree as tree_mod
    from repro_torch.dist.sharding import cache_shardings, distribute, on_mesh, replicate_plain
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import cast_for_compute, make_train_step, place_batch
    from repro_torch.models import decode_step, forward_train, prefill
    from repro_torch.optim import OptConfig, adamw_init

    cfg = _cfg(name, configs)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    out = {}
    req = tree_mod.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = forward_train(cfg, cast_for_compute(req), place_batch(batch, ctx), ctx)
    with replicate_plain(ctx):  # the backward, as make_train_step runs it
        grads = torch.autograd.grad(loss, tree_mod.leaves(req))
    out["loss"] = float(loss.detach())
    out["grads"] = [_full(g) for g in grads]
    p2, _, metrics = make_train_step(cfg, ctx, OptConfig())(params, adamw_init(params), batch)
    out["step_loss"], out["grad_norm"] = float(metrics["loss"]), float(metrics["grad_norm"])
    out["lr"] = float(metrics["lr"])
    out["updated"] = [_full(p) for p in tree_mod.leaves(p2)]

    serve_ctx = None if ctx is None else dataclasses.replace(ctx, mode="serve")
    wc = cast_for_compute(params)
    logits, cache, n = prefill(cfg, wc, place_batch({"tokens": batch["tokens"]}, serve_ctx),
                               MAX_LEN, serve_ctx)
    if on_mesh(serve_ctx):  # the cache's at-rest layout, as make_prefill_step lays it out
        shardings = cache_shardings(cfg, ShapeConfig("prefill", MAX_LEN, B, "prefill"),
                                    serve_ctx)(cache)
        out["cache_placements"] = [repr(s.placements) for s in tree_mod.leaves(shardings)]
        cache = tree_mod.tree_map(distribute, cache, shardings)
    out["logits"] = [_full(logits)]
    out["caches"] = [[_full(c) for c in tree_mod.leaves(cache)]]
    for i in range(DECODES):
        tok = torch.from_numpy(np.argmax(out["logits"][-1], -1).astype(np.int32)[:, None])
        logits, cache = decode_step(cfg, wc, place_batch({"tokens": tok}, serve_ctx), cache,
                                    n + i, serve_ctx)
        out["logits"].append(_full(logits))
        out["caches"].append([_full(c) for c in tree_mod.leaves(cache)])
    return out


def _on_mesh(rank, world, name, shape, params_npz):
    from repro_torch import tree as tree_mod
    from repro_torch.dist import make_ctx, param_shardings
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.runtime.elastic import reshard_tree

    mesh = make_mesh_from_devices(shape, ("data", "model"))
    ctx = make_ctx(mesh, mode="train")
    params = _params(params_npz)
    placed = reshard_tree(params, param_shardings(params, ctx))
    out = _port_run(name, placed, ctx)
    out["param_placements"] = [repr(t.placements) for t in tree_mod.leaves(placed)]
    if rank:  # the other ranks' scalars only: each must equal rank 0's
        out = {k: out[k] for k in ("loss", "step_loss", "grad_norm")}
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _reference(name, tmp_dir):
    """One config's JAX parameters (saved for the ranks), JAX's loss,
    gradients and their global norm (``value_and_grad``, op by op), and the
    port's one-device run on the same parameters."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch.steps import cast_for_compute as jcast
    from repro.models import forward_train as jforward_train, init_params as jinit_params

    jcfg = _cfg(name, jconfigs)
    jparams = jinit_params(jcfg, jax.random.key(0))
    npz = f"{tmp_dir}/{name}.npz"
    np.savez(npz, **{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]})
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}
    with _op_by_op(jax):
        loss, grads = jax.value_and_grad(
            lambda p: jforward_train(jcfg, jcast(p), jbatch, None))(jparams)
    # the port's trees walk in JAX's sorted order: leaf i is JAX's leaf i
    grads = [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)]
    want = {"loss": float(loss), "grads": grads,
            "grad_norm": float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                                           for g in grads)))}
    return npz, want, _port_run(name, _params(npz), None)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_model"))


def _assert_update(got, want, lr):
    """AdamW's first step moves an element by about lr times its gradient's
    sign: within 2·lr, plus the weight decay's 0.1·lr·|p|."""
    for i, (p, q) in enumerate(zip(got, want)):
        assert np.all(np.abs(p - q) <= 2 * lr * (1 + 0.1 * np.abs(q))), i


@pytest.mark.parametrize("name,shape", [(n, (4, 2)) for n in CONFIGS]
                         + [("yi_6b", (2, 2)), ("granite_moe_1b_a400m", (2, 2))],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_train_and_serve_on_mesh_match_one_device_and_jax(name, shape, ref_dir):
    npz, want, one = _reference(name, ref_dir)
    ranks = run_ranks(_on_mesh, shape[0] * shape[1], name, shape, npz, timeout=120)
    r0 = ranks[0]

    for r in ranks:  # every rank holds the same scalars
        assert (r["loss"], r["step_loss"], r["grad_norm"]) == \
            (r0["loss"], r0["step_loss"], r0["grad_norm"])
    assert any("Shard" in p for p in r0["param_placements"])  # FSDP on the mesh
    assert all("Shard(dim=1)" in p for p in r0["cache_placements"])  # batch over 'data'

    # training: the loss, every gradient leaf, grad_norm, the updated leaves
    for got in (r0["loss"], r0["step_loss"]):
        assert abs(got - one["loss"]) <= 1e-5 * abs(one["loss"]), (got, one["loss"])
        assert abs(got - want["loss"]) <= LOSS_ATOL, (got, want["loss"])
    assert len(r0["grads"]) == len(one["grads"]) == len(want["grads"])
    for i, (g, g1, gj) in enumerate(zip(r0["grads"], one["grads"], want["grads"])):
        assert _rel(g, g1) <= GRAD_REL, (i, _rel(g, g1))
        assert _rel(g, gj) <= GRAD_REL, (i, _rel(g, gj))
    assert abs(r0["grad_norm"] - one["grad_norm"]) <= 5e-3 * one["grad_norm"]
    assert abs(r0["grad_norm"] - want["grad_norm"]) <= GRAD_REL * want["grad_norm"]
    _assert_update(r0["updated"], one["updated"], one["lr"])

    # serving: prefill, then DECODES steps; logits and every cache leaf
    tol = 5e-2 if "moe" in name else 1e-2
    assert len(r0["logits"]) == len(one["logits"]) == DECODES + 1
    for lg, lg1 in zip(r0["logits"], one["logits"]):
        assert lg.shape == lg1.shape and np.all(np.isfinite(lg))
        assert np.max(np.abs(lg - lg1)) <= tol * np.max(np.abs(lg1))
    for cs, cs1 in zip(r0["caches"], one["caches"]):
        for c, c1 in zip(cs, cs1):
            assert c.shape == c1.shape
            assert np.max(np.abs(c - c1)) <= tol * np.max(np.abs(c1))
