"""The port's checkpointer (``repro_torch.checkpoint``) and token pipeline
(``repro_torch.data``) against the JAX package's: the reference's own
``TestCheckpointer`` and ``TestDataPipeline``
(``tests/test_runtime_and_ckpt.py``) re-targeted; a checkpoint of a
training state written by either package and read by the other, leaf by
leaf equal, with equal manifests; a bf16 leaf refused; and the pipeline's
batches equal to JAX's, bit for bit, for every family.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import init_params as j_init_params
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as j_adamw_init, adamw_update as j_adamw_update
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenPipeline
from repro_torch.models import init_params, params_from_jax
from repro_torch.optim import adamw_init


class TestCheckpointer:
    def test_roundtrip_and_resume(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
        ck.save(5, tree, metadata={"pipeline": {"step": 5, "seed": 0, "host_id": 0}})
        restored, meta = ck.restore(tree)
        assert torch.equal(restored["w"], tree["w"])
        assert meta["pipeline"]["step"] == 5
        assert ck.latest_step() == 5

    def test_async_save_and_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=2)
        tree = {"w": torch.ones(4)}
        for s in (1, 2, 3):
            ck.save_async(s, tree)
        ck.wait()
        assert ck.latest_step() == 3
        steps = sorted(p.name for p in tmp_path.glob("step_*"))
        assert len(steps) == 2  # keep=2 garbage collection

    def test_atomic_no_partial_dirs(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, {"w": torch.ones(2)})
        assert not list(tmp_path.glob("*.tmp"))

    def test_async_save_snapshots_before_returning(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        tree = {"w": torch.ones(4)}
        ck.save_async(1, tree)
        tree["w"].mul_(3.0)  # an in-place update after save_async returns
        ck.wait()
        restored, _ = ck.restore(tree)
        assert torch.equal(restored["w"], torch.ones(4))

    def test_restore_follows_the_template(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        tree = ({"b": torch.ones(2), "a": torch.arange(3, dtype=torch.int32)}, [torch.zeros(())])
        ck.save(7, tree)
        restored, meta = ck.restore(tree)
        assert meta == {}
        assert isinstance(restored, tuple) and list(restored[0]) == ["b", "a"]
        assert restored[0]["a"].dtype == torch.int32 and torch.equal(restored[0]["a"], tree[0]["a"])
        assert restored[1][0].shape == () and restored[0]["b"].device == torch.device("cpu")
        on_meta, _ = ck.restore(tree, device="meta")
        assert on_meta[0]["b"].device.type == "meta"
        with pytest.raises(ValueError):
            ck.restore({"w": torch.zeros(2)})  # another number of leaves
        with pytest.raises(ValueError):
            ck.restore(({"b": torch.ones(5), "a": torch.zeros(3)}, [torch.zeros(())]))
        with pytest.raises(FileNotFoundError):
            Checkpointer(str(tmp_path / "empty")).restore(tree)

    def test_bf16_leaf_raises(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        with pytest.raises(TypeError, match="bfloat16"):
            ck.save(1, {"w": torch.ones(2, dtype=torch.bfloat16)})
        with pytest.raises(TypeError, match="bfloat16"):
            ck.save_async(1, {"w": torch.ones(2), "x": torch.ones(2, dtype=torch.bfloat16)})
        assert ck.latest_step() is None


def _training_state():
    """A reduced gemma3 training state after one AdamW step in JAX, as
    (JAX tree, the same values as the port's tree)."""
    cfg = jconfigs.reduced_config(jconfigs.get_config("gemma3_1b"))
    params = j_init_params(cfg, jax.random.key(0))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    params, opt_state, _ = j_adamw_update(grads, j_adamw_init(params), params, JOptConfig())
    jtree = (params, opt_state)
    np_tree = jax.tree.map(np.asarray, jtree)
    ttree = (params_from_jax(np_tree[0], "cpu", masters=True),
             {"m": params_from_jax(np_tree[1]["m"], "cpu", masters=True),
              "v": params_from_jax(np_tree[1]["v"], "cpu", masters=True),
              "count": torch.from_numpy(np.array(np_tree[1]["count"]))})
    return jtree, ttree


def _assert_same_checkpoint(dir_a, dir_b, step):
    a, b = dir_a / f"step_{step:08d}", dir_b / f"step_{step:08d}"
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma == mb
    for leaf in ma["leaves"]:
        np.testing.assert_array_equal(np.load(a / leaf["file"]), np.load(b / leaf["file"]))
        assert np.load(a / leaf["file"]).dtype == np.load(b / leaf["file"]).dtype


def test_checkpoints_cross_between_packages(tmp_path):
    jtree, ttree = _training_state()
    meta = {"pipeline": {"step": 3, "seed": 0, "host_id": 0}}
    JCheckpointer(str(tmp_path / "jax")).save(3, jtree, metadata=meta)
    Checkpointer(str(tmp_path / "torch")).save(3, ttree, metadata=meta)
    _assert_same_checkpoint(tmp_path / "jax", tmp_path / "torch", 3)
    keys = [leaf["key"] for leaf in
            json.loads((tmp_path / "jax" / "step_00000003" / "manifest.json").read_text())["leaves"]]
    assert keys[0] == "0/embed" and "1/count" in keys and keys == sorted(keys)

    # the port reads JAX's checkpoint into a fresh template of its own
    cfg = tconfigs.reduced_config(tconfigs.get_config("gemma3_1b"))
    fresh = init_params(cfg, 1, "cpu", masters=True)
    got, got_meta = Checkpointer(str(tmp_path / "jax")).restore((fresh, adamw_init(fresh)))
    assert got_meta == meta
    for (path, g), w in zip(tree_mod.items(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg="/".join(path))
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
    # and JAX reads the port's
    back, back_meta = JCheckpointer(str(tmp_path / "torch")).restore(jtree)
    assert back_meta == meta
    for b, w in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(w))


def test_async_checkpoints_equal_between_packages(tmp_path):
    jtree, ttree = _training_state()
    jck, tck = JCheckpointer(str(tmp_path / "jax"), keep=1), Checkpointer(str(tmp_path / "torch"),
                                                                          keep=1)
    for step in (1, 2):
        jck.save_async(step, jtree, metadata={"step": step})
        tck.save_async(step, ttree, metadata={"step": step})
    jck.wait()
    tck.wait()
    assert [p.name for p in (tmp_path / "torch").iterdir()] == ["step_00000002"]
    _assert_same_checkpoint(tmp_path / "jax", tmp_path / "torch", 2)


def _shape(seq, batch):
    return dataclasses.replace(tconfigs.SHAPES["train_4k"], seq_len=seq, global_batch=batch)


class TestDataPipeline:
    def test_deterministic_and_disjoint_hosts(self):
        cfg = tconfigs.reduced_config(tconfigs.get_config("yi_6b"))
        shape = _shape(16, 4)
        p0 = TokenPipeline(cfg, shape, host_id=0, n_hosts=2, seed=1)
        p1 = TokenPipeline(cfg, shape, host_id=1, n_hosts=2, seed=1)
        b0a, b0b = p0.batch_at(3), p0.batch_at(3)
        np.testing.assert_array_equal(b0a["tokens"], b0b["tokens"])  # deterministic
        assert not np.array_equal(b0a["tokens"], p1.batch_at(3)["tokens"])  # disjoint

    def test_state_resume(self):
        cfg = tconfigs.reduced_config(tconfigs.get_config("yi_6b"))
        shape = _shape(16, 4)
        p = TokenPipeline(cfg, shape, seed=7)
        it = iter(p)
        next(it), next(it)
        st = p.state()
        want = p.batch_at(p.step)
        p2 = TokenPipeline(cfg, shape, seed=0)
        p2.restore(st)
        np.testing.assert_array_equal(p2.batch_at(p2.step)["tokens"], want["tokens"])

    def test_batch_must_divide_across_hosts(self):
        cfg = tconfigs.reduced_config(tconfigs.get_config("yi_6b"))
        with pytest.raises(ValueError):
            TokenPipeline(cfg, _shape(16, 3), n_hosts=2)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_batches_equal_jax(arch):
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    jshape = dataclasses.replace(jconfigs.SHAPES["train_4k"], seq_len=32, global_batch=4)
    for host in (0, 1):
        tp = TokenPipeline(tcfg, _shape(32, 4), host_id=host, n_hosts=2, seed=3)
        jp = JTokenPipeline(jcfg, jshape, host_id=host, n_hosts=2, seed=3)
        for step in (0, 1, 17):
            got, want = tp.batch_at(step), jp.batch_at(step)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        assert tp.state() == jp.state()
