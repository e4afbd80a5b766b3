"""The port's ``forward_train`` against the JAX package's on the CPU: the
loss and every gradient leaf for the reduced configs of the dense, moe,
vlm and audio families, and the fp32 master weights. RWKV-6 and Zamba2 are
held in ``test_torch_train_recurrent.py``, the train step, the launcher,
the kernels' refusal of inputs that need a gradient and the default device
in ``test_torch_train_step.py``; this module holds their shared helpers.

JAX runs op by op (``jax.disable_jit()``), which rounds every bf16
operation as the port does; its weights come across through
``params_from_jax(..., masters=True)`` (fp32, as JAX's ``init_params``
returns them), its inputs from numpy seeds (the batches of
``tests/test_arch_smoke.py``: B = 2, S = 32).

Tolerances, and why: the loss 1e-3 absolute; every gradient leaf 2e-2
relative in L2 norm. The bf16 products' fp32 sums, exponentials and
logarithms round in the last place otherwise in a few elements, which the
layers of a model at random weights amplify: the leaves land at 0.1–1.2%.
"""


import contextlib
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import tree as tree_mod
from repro_torch.models import forward_train, init_params, params_from_jax

B, S = 2, 32
LOSS_ATOL = 1e-3
GRAD_REL = 2e-2
# held layer by layer (test_torch_train_recurrent.py)
RECURRENT = ("rwkv6_1p6b", "zamba2_2p7b")
TRANSFORMERS = [a for a in tconfigs.ARCH_IDS if a not in RECURRENT]


@contextlib.contextmanager
def _op_by_op(jax):
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", False)


def make_batch(cfg, rng):
    """numpy arrays of one training batch, the reference smoke test's."""
    if cfg.family == "audio":
        return {"frame_embeds": rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S, cfg.num_codebooks)).astype(np.int32)}
    if cfg.family == "vlm":
        s_text = S - cfg.num_patches
        return {"patch_embeds": rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).astype(np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _grads(params, loss_fn):
    """(loss, gradient of every leaf) of ``loss_fn`` over a tree of tensors."""
    req = tree_mod.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(req)
    grads = torch.autograd.grad(loss, tree_mod.leaves(req))
    return float(loss.detach()), dict(zip(("/".join(p) for p, _ in tree_mod.items(params)), grads))


@functools.lru_cache(maxsize=None)
def arch_run(arch):
    """One arch's JAX parameters and its value_and_grad of forward_train
    (op by op), the port's masters and its loss and gradients."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import model as jmodel

    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu", masters=True)
    batch = make_batch(jcfg, np.random.default_rng(1))
    with _op_by_op(jax):
        jloss, jgrads = jax.value_and_grad(
            lambda p: jmodel.forward_train(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})
        )(jparams)
    tloss, tgrads = _grads(tparams, lambda p: forward_train(tcfg, p, _torch_batch(batch)))
    jflat = {"/".join(str(k.key) for k in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, batch=batch,
                jloss=float(jloss), tloss=tloss, jgrads=jflat, tgrads=tgrads)


def check_masters(arch):
    """The masters: every leaf fp32, JAX's keys in JAX's order, and the
    draws of the serving parameters before their bf16 cast."""
    run = arch_run(arch)
    tp = run["tparams"]
    assert ["/".join(p) for p, _ in tree_mod.items(tp)] == list(run["jgrads"])
    assert all(t.dtype == torch.float32 for t in tree_mod.leaves(tp))
    cfg = run["tcfg"]
    masters = init_params(cfg, 0, "cpu", masters=True)
    serve = init_params(cfg, 0, "cpu")
    for (path, m), s in zip(tree_mod.items(masters), tree_mod.leaves(serve)):
        assert m.dtype == torch.float32 and m.shape == s.shape
        assert torch.equal(m.to(s.dtype), s), "/".join(path)  # the same draws, cast for serving


def check_loss(arch):
    run = arch_run(arch)
    assert abs(run["tloss"] - run["jloss"]) <= LOSS_ATOL
    assert 0.0 < run["tloss"] < 2.0 * np.log(run["tcfg"].padded_vocab) + 5.0


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_masters_are_fp32_with_jax_keys_and_the_serve_draws(arch):
    check_masters(arch)


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_loss_matches_jax(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_every_gradient_leaf_matches_jax(arch):
    run = arch_run(arch)
    assert run["tgrads"].keys() == run["jgrads"].keys()
    worst = max((_rel(g, run["jgrads"][k]), k) for k, g in run["tgrads"].items())
    assert worst[0] <= GRAD_REL, worst


