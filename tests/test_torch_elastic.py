"""The elastic story of ``tests/test_elastic_and_compression.py`` on the
port, over gloo ranks on the CPU: the reduced yi_6b (JAX's parameters,
``params_from_jax``) laid out on a 4×2 world of 8 ranks and checkpointed;
then half the ranks are lost and a fresh 2×2 world of 4 ranks (as an
elastic restart under ``torchrun`` forms) resumes it with
``resume_on_mesh``: the leaves bit-equal to the saved ones, laid out on the
2×2 mesh, and one ``make_train_step`` there within 1e-3 of JAX's
``ctx=None`` train step on the same parameters and batch. JAX is imported
in the test only: the spawned ranks import this module.
"""

import numpy as np
import torch

from torch_dist_ranks import run_ranks


def _batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 100, (4, 16)).astype(np.int32),
            "labels": rng.integers(0, 100, (4, 16)).astype(np.int32)}


def _run_and_save(rank, world, params_npz, ckpt_dir):
    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.dist import make_ctx, param_shardings
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.runtime.elastic import reshard_tree

    params = _params(params_npz)
    mesh = make_mesh_from_devices((4, 2), ("data", "model"))
    pa = reshard_tree(params, param_shardings(params, make_ctx(mesh, mode="train")))
    placed = [repr(t.placements) for t in tree_mod.leaves(pa)]
    Checkpointer(ckpt_dir).save(7, pa, metadata={"note": "pre-failure"})
    return placed


def _resume(rank, world, params_npz, ckpt_dir):
    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.dist import make_ctx
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.runtime.elastic import resume_on_mesh

    template = _params(params_npz)
    mesh = make_mesh_from_devices((2, 2), ("data", "model"))
    pb, meta = resume_on_mesh(Checkpointer(ckpt_dir), template, mesh, mode="train")
    equal = all(torch.equal(b.full_tensor(), a) for a, b in
                zip(tree_mod.leaves(template), tree_mod.leaves(pb)))
    on_mesh = all(b.device_mesh.shape == (2, 2) and b.device_mesh.mesh_dim_names == ("data", "model")
                  for b in tree_mod.leaves(pb))
    cfg = reduced_config(get_config("yi_6b"))
    step = make_train_step(cfg, make_ctx(mesh, mode="train"), OptConfig())
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    p2, _, metrics = step(pb, adamw_init(pb), batch)
    return {"note": meta["note"], "equal": equal, "on_mesh": on_mesh,
            "placements": [repr(t.placements) for t in tree_mod.leaves(p2)],
            "loss": float(metrics["loss"])}


def _params(params_npz):
    from repro_torch.models import params_from_jax

    flat = dict(np.load(params_npz))
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return params_from_jax(tree, "cpu", masters=True)


def test_checkpoint_on_4x2_resume_on_2x2(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced_config
    from repro.launch.steps import make_train_step
    from repro.models import init_params
    from repro.optim import OptConfig, adamw_init

    cfg = reduced_config(get_config("yi_6b"))
    params = init_params(cfg, jax.random.key(0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    _, _, metrics = jax.jit(make_train_step(cfg, None, OptConfig()))(
        params, adamw_init(params), batch)
    want = float(metrics["loss"])

    ckpt = str(tmp_path / "ckpt")
    saved = run_ranks(_run_and_save, 8, str(npz), ckpt, timeout=120)
    assert any("Shard" in p for p in saved[0])  # FSDP layouts on the 4x2 mesh
    ranks = run_ranks(_resume, 4, str(npz), ckpt, timeout=120)
    for r in ranks:
        assert r["note"] == "pre-failure"
        assert r["equal"], "the restored leaves equal the saved ones bit for bit"
        assert r["on_mesh"], "every leaf lives on the 2x2 mesh"
        assert r["loss"] == ranks[0]["loss"]
    assert any("Shard" in p for p in ranks[0]["placements"])  # the step keeps the layouts
    assert abs(ranks[0]["loss"] - want) <= 1e-3, (ranks[0]["loss"], want)
