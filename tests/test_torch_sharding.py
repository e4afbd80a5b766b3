"""The port's layout rules (``repro_torch.dist.sharding``) against the JAX
package's, and the mesh helpers on the CPU.

The specs are compared on abstract meshes (axis names and sizes, no ranks):
``jax.sharding.AbstractMesh`` on the JAX side, the port's ``AbstractMesh``
on the other, over every arch × shape × mesh × mode, with the full
configs' parameters and caches as meta tensors held to ``jax.eval_shape``'s.
"""

import functools
import itertools
import pathlib
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.dist import sharding as jsh
from repro.launch import inputs as jinputs
from repro_torch import tree as tree_mod
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.dist import sharding as tsh
from repro_torch.launch import inputs as tinputs
from repro_torch.launch.mesh import make_mesh_from_devices

MESHES = [((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _jax_spec(sharding):
    return None if sharding is None else tuple(sharding.spec)


def _port_spec(sharding):
    return None if sharding is None else tuple(sharding.spec)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return jinputs.params_specs(get_config(arch)), tinputs.params_specs(tget_config(arch))


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name):
    return (jinputs.cache_specs(get_config(arch), SHAPES[shape_name]),
            tinputs.cache_specs(tget_config(arch), TSHAPES[shape_name]))


def _leaves_with_shape(tree, leaves):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in leaves(tree)]


@pytest.mark.parametrize("arch,shape_name,mesh,mode", list(itertools.product(
    ARCH_IDS, list(SHAPES), MESHES, ("train", "serve"))),
    ids=lambda v: "x".join(map(str, v[0])) if isinstance(v, tuple) else str(v))
def test_layout_specs_equal_jax(arch, shape_name, mesh, mode):
    sizes, names = mesh
    jctx = jsh.make_ctx(jax.sharding.AbstractMesh(sizes, names), mode=mode)
    tctx = tsh.make_ctx(tsh.AbstractMesh(sizes, names), mode=mode)
    assert (tctx.mode, tctx.dp, tctx.model_axis, tctx.analysis) == \
        (jctx.mode, jctx.dp, jctx.model_axis, jctx.analysis)
    cfg, tcfg = get_config(arch), tget_config(arch)
    shape, tshape = SHAPES[shape_name], TSHAPES[shape_name]

    # the full configs' parameters and caches: meta tensors against eval_shape
    jp, tp = _params(arch)
    assert _leaves_with_shape(tp, tree_mod.leaves) == [
        (tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jp)]
    assert all(t.device.type == "meta" for t in tree_mod.leaves(tp))
    jc, tc = _caches(arch, shape_name)
    assert _leaves_with_shape(tc, tree_mod.leaves) == [
        (tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jc)]
    jin, tin = jinputs.input_specs(cfg, shape), tinputs.input_specs(tcfg, tshape)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jin.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tin.items()}

    # the layouts, leaf by leaf in JAX's order
    assert [_port_spec(s) for s in tree_mod.leaves(tsh.param_shardings(tp, tctx))] == \
        [_jax_spec(s) for s in jax.tree.leaves(jsh.param_shardings(jp, jctx))]
    assert {k: tuple(v) for k, v in tsh.input_shardings(tcfg, tshape, tctx).items()} == \
        {k: tuple(v) for k, v in jsh.input_shardings(cfg, shape, jctx).items()}
    tcs = tree_mod.leaves(tsh.cache_shardings(tcfg, tshape, tctx)(tc))
    jcs = jax.tree.leaves(jsh.cache_shardings(cfg, shape, jctx)(jc))
    assert [_port_spec(s) for s in tcs] == [_jax_spec(s) for s in jcs]


def test_make_ctx_and_off_mesh_rules_equal_jax():
    for mode in ("train", "serve"):
        j, t = jsh.make_ctx(None, mode=mode), tsh.make_ctx(None, mode=mode)
        assert (t.mesh, t.mode, t.dp, t.model_axis, t.analysis) == \
            (j.mesh, j.mode, j.dp, j.model_axis, j.analysis)
    cfg, tcfg = get_config("yi_6b"), tget_config("yi_6b")
    assert tsh.param_shardings(tinputs.params_specs(tcfg), None) is None
    assert {k: tuple(v) for k, v in tsh.input_shardings(tcfg, TSHAPES["train_4k"], None).items()} \
        == {k: tuple(v) for k, v in jsh.input_shardings(cfg, SHAPES["train_4k"], None).items()}
    tc = tinputs.cache_specs(tcfg, TSHAPES["decode_32k"])
    assert all(s is None for s in tree_mod.leaves(
        tsh.cache_shardings(tcfg, TSHAPES["decode_32k"], None)(tc), ))


def test_constraints_are_no_ops_off_mesh():
    q, k, v = (torch.randn(2, 8, 4, 16) for _ in range(3))
    for ctx in (None, tsh.make_ctx(None)):
        out = tsh.constrain_qkv(q, k, v, ctx)
        assert all(a is b for a, b in zip(out, (q, k, v)))
        x = torch.randn(2, 8, 32)
        assert tsh.constrain_hidden(x, None, ctx) is x


def test_spec_type_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert tuple(tsh.P(("data",), None)) == tuple(jax.sharding.PartitionSpec(("data",), None))
    assert tuple(tsh.P(("pod", "data"), None, "model")) == \
        tuple(jax.sharding.PartitionSpec(("pod", "data"), None, "model"))
    mesh = tsh.AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert tsh.placements(tsh.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.placements(tsh.P(("data", "pod")), mesh)


def test_make_mesh_from_devices_raises_with_too_few_ranks():
    # no process group is started: the count is checked first
    with pytest.raises(ValueError, match=r"needs 256 ranks, only 1 available"):
        make_mesh_from_devices((16, 16), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match=r"needs 8 ranks, only 4 available"):
        make_mesh_from_devices((4, 2), ("data", "model"), devices=range(4), device_type="cpu")
    assert not torch.distributed.is_initialized()


def test_distribution_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import repro_torch.dist, repro_torch.dist.sharding, repro_torch.runtime.elastic\n"
        "import repro_torch.launch.mesh, repro_torch.launch.inputs\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
        "from repro_torch.optim.grad_compression import compressed_psum, make_dp_grad_reducer\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


ONE_RANK = r"""
import json, sys
import torch
from repro_torch import tree as tree_mod
from repro_torch.configs import get_config, reduced_config
from repro_torch.dist import make_ctx, param_shardings
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.models import init_params, prefill
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.runtime.elastic import reshard_tree

mesh = make_mesh_from_devices((1, 1), ("data", "model"), device_type="cpu")
out = {"backend": torch.distributed.get_backend(), "world": torch.distributed.get_world_size()}
try:
    train_mod.setup(train_mod.parse_args(["--mesh", "single", "--device", "cpu", "--reduced"]))
except ValueError as e:
    out["launcher"] = str(e)
cfg = reduced_config(get_config(sys.argv[1]))
g = torch.Generator().manual_seed(1)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g),
         "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=g)}
params = init_params(cfg, 0, "cpu", masters=True)
ctx = make_ctx(mesh, mode="train")
placed = reshard_tree(params, param_shardings(params, ctx))
losses = {}
for name, c, p in (("plain", None, params), ("mesh", ctx, placed)):
    step = make_train_step(cfg, c, OptConfig(), microbatches=2)
    p2, _, m = step(p, adamw_init(p), batch)
    losses[name] = [float(m["loss"]), float(m["grad_norm"])]
    losses[name + "_leaves"] = [t.full_tensor() if hasattr(t, "full_tensor") else t
                                for t in tree_mod.leaves(p2)]
out["train"] = [losses["plain"], losses["mesh"]]
out["leaves_equal"] = all(torch.equal(a, b) for a, b in
                          zip(losses["plain_leaves"], losses["mesh_leaves"]))
sp = init_params(cfg, 0, "cpu")
sctx = make_ctx(mesh, mode="serve")
ssp = reshard_tree(sp, param_shardings(sp, sctx))
lg, cache, _ = prefill(cfg, ssp, {"tokens": batch["tokens"]}, 24, sctx)
rlg, rcache, _ = prefill(cfg, sp, {"tokens": batch["tokens"]}, 24)
same = torch.equal(lg.full_tensor(), rlg) and all(
    torch.equal(a.full_tensor(), b) for a, b in zip(tree_mod.leaves(cache), tree_mod.leaves(rcache)))
tok, c1 = make_prefill_step(cfg, sctx, 24)(ssp, {"tokens": batch["tokens"]})
rtok, rc1 = make_prefill_step(cfg, None, 24)(sp, {"tokens": batch["tokens"]})
for i in range(3):
    same &= torch.equal(tok, rtok)
    tok, c1 = make_decode_step(cfg, sctx)(ssp, c1, {"tokens": tok}, 16 + i)
    rtok, rc1 = make_decode_step(cfg, None)(sp, rc1, {"tokens": rtok}, 16 + i)
same &= all(torch.equal(a.full_tensor(), b) for a, b in
            zip(tree_mod.leaves(c1), tree_mod.leaves(rc1)))
out["serve_equal"] = bool(same)
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["gemma3_1b", "granite_moe_1b_a400m"])
def test_one_rank_mesh_equals_one_device(arch):
    """A 1×1 mesh on a gloo world of one (what the card runs over NCCL):
    every collective is an identity, so the train step, the prefill and the
    decode steps equal the ``ctx=None`` ones bit for bit; and the launcher's
    ``--mesh single`` raises, 256 ranks needed and 1 available."""
    import json
    import os

    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", ONE_RANK, arch], capture_output=True, text=True,
                          timeout=120, cwd=root,
                          env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["backend"] == "gloo" and out["world"] == 1
    assert "mesh (16, 16) needs 256 ranks, only 1 available" in out["launcher"]
    assert out["train"][0] == out["train"][1]
    assert out["leaves_equal"] and out["serve_equal"]
