"""The port's MoE on a mesh (``local_map``: the train layout's FSDP
gathers, the serve layout's tensor-parallel sum) against its own one-device
result and the JAX package's, as ``tests/test_moe_sharded.py`` holds JAX's:
8 gloo ranks on the CPU in a 4×2 (data, model) mesh, that test's inputs
(B, S, D, E, F, K = 4, 16, 32, 4, 64, 2, numpy seed 0) and its tolerance
(rtol = atol = 5e-2). JAX is imported in the test only: the spawned ranks
import this module.
"""

import numpy as np
import torch

from torch_dist_ranks import run_ranks

B, S, D, E, F, K = 4, 16, 32, 4, 64, 2


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    params = {
        "router": rng.normal(0, 0.1, (D, E)).astype(np.float32),
        "w_gate": rng.normal(0, 0.1, (E, D, F)).astype(np.float32),
        "w_up": rng.normal(0, 0.1, (E, D, F)).astype(np.float32),
        "w_down": rng.normal(0, 0.1, (E, F, D)).astype(np.float32),
    }
    return x, params


def _moe_on_mesh(rank, world):
    from repro_torch.dist import make_ctx
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.models.moe import moe_ffn

    x, params = _inputs()
    x = torch.from_numpy(x).to(torch.bfloat16)
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = make_mesh_from_devices((4, 2), ("data", "model"))
    out = {"local": moe_ffn(x, params, k=K, ctx=None).float().numpy()}
    for mode in ("train", "serve"):
        got = moe_ffn(x, params, k=K, ctx=make_ctx(mesh, mode=mode))
        out[mode] = got.full_tensor().float().numpy()
        out[mode + "_placements"] = [repr(p) for p in got.placements]
    # the gradient flows through the train layout's gathers
    req = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y = moe_ffn(x, req, k=K, ctx=make_ctx(mesh, mode="train"))
    loss = torch.sum(torch.square(y.float())).full_tensor()
    grads = torch.autograd.grad(loss, list(req.values()))
    out["grad_norm"] = float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads)))
    req = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = torch.sum(torch.square(moe_ffn(x, req, k=K).float()))
    grads = torch.autograd.grad(loss, list(req.values()))
    out["grad_norm_local"] = float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads)))
    return out


def test_moe_on_a_4x2_mesh_matches_local_and_jax():
    import jax.numpy as jnp

    from repro.models.moe import moe_ffn as jax_moe_ffn

    x, params = _inputs()
    want = np.asarray(jax_moe_ffn(jnp.asarray(x).astype(jnp.bfloat16),
                                  {k: jnp.asarray(v) for k, v in params.items()}, k=K, ctx=None),
                      np.float32)
    ranks = run_ranks(_moe_on_mesh, 8, timeout=120)
    r0 = ranks[0]
    np.testing.assert_allclose(r0["local"], want, rtol=5e-2, atol=5e-2)
    for mode in ("train", "serve"):
        for r in ranks:  # every rank holds the same global result
            np.testing.assert_array_equal(r[mode], r0[mode])
        np.testing.assert_allclose(r0[mode], r0["local"], rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(r0[mode], want, rtol=5e-2, atol=5e-2)
    assert r0["train_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]  # batch, sequence
    assert r0["serve_placements"] == ["Shard(dim=0)", "Replicate()"]
    assert np.isfinite(r0["grad_norm"]) and r0["grad_norm"] > 0
    np.testing.assert_allclose(r0["grad_norm"], r0["grad_norm_local"], rtol=5e-2)
