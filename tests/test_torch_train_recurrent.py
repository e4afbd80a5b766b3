"""RWKV-6's and Zamba2's ``forward_train`` against the JAX package's on
the CPU (op by op, as ``test_torch_train.py``): the fp32 masters, the loss
over the whole model (1e-3 absolute), and every layer's gradients.

Why layer by layer: these two families' whole-model gradients at random
weights are unstable in the JAX package itself, beyond the 2e-2 bar that
``test_torch_train.py`` holds the other families to. Moving every element
of RWKV-6's ``w0`` or of Zamba2's ``d_skip`` by one fp32 ulp moves JAX's own
gradients by up to 2.8% and 21% in relative L2 norm, and JAX's compiled
gradients differ from its op-by-op ones by 43% and 29%; the port's differ
from JAX's op-by-op ones by 3.8% and 11%. The first ops where the port
differs are fp32 exponentials one ulp apart in a few elements (RWKV-6's
decay ``exp(-exp(w))``, Mamba2's softplus). So the same bar, 2e-2 relative
in L2 norm, holds each layer's output, input gradient and parameter
gradients: each RWKV-6 layer, each Mamba2 layer and each application of
Zamba2's shared block, from JAX's hidden state at its depth and one seeded
cotangent (they land at 0.1–1.2%).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_mod
from repro_torch.models import model as tmodel
from test_torch_train import (B, GRAD_REL, RECURRENT, S, _op_by_op, _rel, arch_run, check_loss,
                              check_masters)


@pytest.mark.parametrize("arch", RECURRENT)
def test_masters_are_fp32_with_jax_keys_and_the_serve_draws(arch):
    check_masters(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_matches_jax(arch):
    check_loss(arch)


def _layer_units(arch):
    """For RWKV-6 and Zamba2: each layer as (name, JAX function of (h,
    params), its JAX params, port function of (h, params), its port
    params), in the order the model applies them."""
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    from repro.models import model as jmodel
    from repro.models import ssm as jssm

    run = arch_run(arch)
    jcfg, tcfg, jp, tp = run["jcfg"], run["tcfg"], run["jparams"], run["tparams"]
    eps = jcfg.norm_eps
    if arch == "rwkv6_1p6b":
        def jrwkv(h, p):  # the body of repro.models.model._rwkv_stack
            h = h + jssm.rwkv6_block(jlayers.rms_norm(h, p["ln1"], eps), p, jcfg)
            y, _ = jssm.rwkv6_channel_mix(jlayers.rms_norm(h, p["ln2"], eps), p)
            return h + y

        trwkv = functools.partial(tmodel._rwkv_layer, cfg=tcfg)
        return [(f"layer {i}", jrwkv, {k: v[i] for k, v in jp["layers"].items()},
                 trwkv, tmodel._unstack(tp["layers"], i)) for i in range(jcfg.num_layers)]

    s = S
    pos = jnp.broadcast_to(jnp.arange(s), (B, s))
    tpos = torch.arange(s).expand(B, s)

    def jmamba(h, p):  # the inner body of repro.models.model._hybrid_stack
        return h + jssm.mamba2_block(jlayers.rms_norm(h, p["ln"], eps), p, jcfg)

    def jshared(h, p):
        h, _ = jmodel._attn_block(h, p, jcfg, window=s, positions=pos)
        return jmodel._ffn_block(h, p, jcfg)

    tmamba = functools.partial(tmodel._mamba_layer, cfg=tcfg)
    tshared = functools.partial(tmodel._transformer_layer, cfg=tcfg, window=s, positions=tpos,
                                prefix_len=0)
    units = []
    nb, ae = jp["mamba"]["ln"].shape[:2]
    for sb in range(nb):
        units += [(f"super-block {sb} Mamba2 {j}", jmamba,
                   {k: v[sb, j] for k, v in jp["mamba"].items()}, tmamba,
                   tmodel._unstack(tmodel._unstack(tp["mamba"], sb), j)) for j in range(ae)]
        units.append((f"super-block {sb} shared block", jshared, jp["shared_attn"], tshared,
                      tp["shared_attn"]))
    return units


@functools.lru_cache(maxsize=None)
def layer_run(arch):
    """Each layer's output, input gradient and parameter gradients, JAX's
    (op by op) and the port's, from JAX's hidden state at its depth and a
    seeded cotangent."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as jmodel

    run = arch_run(arch)
    batch = {k: jnp.asarray(v) for k, v in run["batch"].items()}
    rng = np.random.default_rng(2)
    out = []
    with _op_by_op(jax):
        h, _ = jmodel._embed_inputs(run["jcfg"], run["jparams"], batch)
        for name, jfn, jp, tfn, tp in _layer_units(arch):
            y, vjp = jax.vjp(jfn, h, jp)
            ct = rng.normal(0, 1, y.shape).astype(np.float32)
            jgh, jgp = vjp(jnp.asarray(ct).astype(y.dtype))
            th = torch.from_numpy(np.array(h.astype(jnp.float32))).to(torch.bfloat16)
            th.requires_grad_(True)
            treq = tree_mod.tree_map(lambda t: t.detach().requires_grad_(True), tp)
            ty = tfn(th, treq)
            tg = torch.autograd.grad(ty, [th] + tree_mod.leaves(treq),
                                     grad_outputs=torch.from_numpy(ct).to(torch.bfloat16))
            rels = {"output": _rel(ty, y.astype(jnp.float32)),
                    "input": _rel(tg[0], jgh.astype(jnp.float32))}
            for (path, _), g in zip(tree_mod.items(tp), tg[1:]):
                rels["/".join(path)] = _rel(g, _get(jgp, path))
            out.append((name, rels))
            h = y
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree).astype(np.float32)


@pytest.mark.parametrize("arch,index", [("rwkv6_1p6b", i) for i in range(4)]
                         + [("zamba2_2p7b", i) for i in range(8)])
def test_layer_gradients_match_jax(arch, index):
    name, rels = layer_run(arch)[index]
    assert rels["output"] <= GRAD_REL, (name, rels)
    worst = max((r, k) for k, r in rels.items())
    assert worst[0] <= GRAD_REL, (name, worst)


def test_layer_units_cover_every_layer_parameter():
    for arch, count in (("rwkv6_1p6b", 4), ("zamba2_2p7b", 8)):
        assert len(layer_run(arch)) == count
        run = arch_run(arch)
        held = {k for _, rels in layer_run(arch) for k in rels}
        stack = "layers" if arch == "rwkv6_1p6b" else "mamba"
        want = {k.split("/", 1)[1] for k in run["tgrads"] if k.startswith((stack, "shared_attn"))}
        assert want <= held, want - held
