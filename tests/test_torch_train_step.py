"""The port's train step, launcher and training guards against the JAX
package's on the CPU: ``make_train_step`` (AdamW over fp32 masters,
``cast_for_compute``, microbatches 1 and 2) over two steps against JAX's
run op by op, JAX's cast rule, the reference's own train smoke test
(``tests/test_arch_smoke.py``) re-targeted, the masking of labels, the
train route (no kernel, whatever the device), the kernels' refusal of
inputs that need a gradient, the default device, and ``python -m
repro_torch.launch.train`` with a checkpoint and a resume.

Tolerances of the train step (the reduced granite-moe, the launcher's
OptConfig; shared helpers and the model's bars in ``test_torch_train.py``):
loss 1e-3 absolute, ``grad_norm`` 2e-2 relative, ``lr`` 1e-6 relative. An
AdamW step moves each element by about ``lr`` times the sign of its
gradient, so an element whose gradient is near zero may move the other
way: each parameter element is held within twice the summed learning
rates (plus the weight decay's 0.1·lr·|p|) of JAX's, and 95% of each
leaf's elements within 5% of that sum (2% of them lie beyond it at the
second step).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import tree as tree_mod
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import morph_recon as mr_kernel
from repro_torch.kernels import ssm_scan as ss_kernel
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import forward_train, init_params, params_from_jax
from repro_torch.models import model as tmodel
from repro_torch.optim import OptConfig, adamw_init
from test_torch_train import (GRAD_REL, LOSS_ATOL, S, _grads, _op_by_op, _torch_batch,
                              make_batch)


def _train_step_runs(microbatches):
    """Two train steps of the reduced granite-moe (stacked norms and an fp32
    router, both cast by cast_for_compute) in JAX (op by op) and in the
    port, from the same masters and batches. Returns each step's (JAX
    params, JAX metrics, port params, port metrics)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import model as jmodel
    from repro.optim import OptConfig as JOptConfig
    from repro.optim import adamw_init as j_adamw_init

    arch = "granite_moe_1b_a400m"
    jcfg = jconfigs.reduced_config(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    kw = dict(total_steps=10)  # the launcher's, for 10 steps
    jstep = jsteps.make_train_step(jcfg, None, JOptConfig(**kw), cast_before_gather=True,
                                   microbatches=microbatches)
    tstep = tsteps.make_train_step(tcfg, None, OptConfig(**kw), cast_before_gather=True,
                                   microbatches=microbatches)
    jparams = jmodel.init_params(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu", masters=True)
    jstate, tstate = j_adamw_init(jparams), adamw_init(tparams)
    rng = np.random.default_rng(4)
    out = []
    for _ in range(2):
        batch = make_batch(jcfg, rng)
        with _op_by_op(jax):
            jparams, jstate, jm = jstep(jparams, jstate,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, tm = tstep(tparams, tstate, _torch_batch(batch))
        out.append((jparams, jm, tparams, tm))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches):
    import jax

    lr_total = 0.0
    for step, (jp, jm, tp, tm) in enumerate(_train_step_runs(microbatches)):
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL, step
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= GRAD_REL, step
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        lr_total += float(jm["lr"])
        for (path, t), j in zip(tree_mod.items(tp), jax.tree.leaves(jp)):
            assert t.dtype == torch.float32
            j = np.asarray(j)
            d = np.abs(t.numpy() - j)
            name = "/".join(path)
            assert (d <= lr_total * (2.0 + 0.1 * np.abs(j)) + 1e-6 * np.abs(j)).all(), (name, step)
            assert (d <= 0.05 * lr_total).mean() >= 0.95, (name, step)


def test_cast_for_compute_is_jax_rule():
    cfg = tconfigs.reduced_config(tconfigs.get_config("zamba2_2p7b"))
    params = init_params(cfg, 0, "cpu", masters=True)
    cast = tsteps.cast_for_compute(params)
    for (path, p), c in zip(tree_mod.items(params), tree_mod.leaves(cast)):
        want = torch.bfloat16 if p.dim() >= 2 else torch.float32
        assert c.dtype == want, "/".join(path)
    assert cast["mamba"]["ln"].dtype == torch.bfloat16  # the stacked norms (9, 6, D) at full size
    assert cast["shared_attn"]["ln1"].dtype == torch.float32  # one dim
    assert tsteps.cast_for_compute(params, enable=False) is params
    moe = init_params(tconfigs.reduced_config(tconfigs.get_config("granite_moe_1b_a400m")), 0,
                      "cpu", masters=True)
    assert tsteps.cast_for_compute(moe)["layers"]["router"].dtype == torch.bfloat16
    # gradients reach the fp32 masters
    w = params["final_norm"].detach().requires_grad_(True)
    m = params["lm_head"].detach().requires_grad_(True)
    out = tsteps.cast_for_compute({"a": w, "b": m})
    (out["a"].sum() + out["b"].float().sum()).backward()
    assert w.grad.dtype == torch.float32 and m.grad.dtype == torch.float32


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_train_step_loss_finite(arch):
    """tests/test_arch_smoke.py's train-step test, on the port."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    params = init_params(cfg, 0, "cpu", masters=True)
    batch = _torch_batch(make_batch(cfg, np.random.default_rng(1)))
    loss, grads = _grads(params, lambda p: forward_train(cfg, p, batch))
    assert np.isfinite(loss), f"{arch}: loss={loss}"
    # plausible initial CE: ~log(vocab)
    assert 0.0 < loss < 2.0 * np.log(cfg.padded_vocab) + 5.0
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values())))
    assert np.isfinite(gnorm) and gnorm > 0.0


def test_forward_train_labels_below_zero_are_not_counted():
    cfg = tconfigs.reduced_config(tconfigs.get_config("gemma3_1b"))
    params = init_params(cfg, 0, "cpu", masters=True)
    batch = _torch_batch(make_batch(cfg, np.random.default_rng(1)))
    with torch.no_grad():
        full = forward_train(cfg, params, batch)
        masked = dict(batch, labels=batch["labels"].clone())
        masked["labels"][:, S // 2:] = -1
        half = forward_train(cfg, params, masked)
        first = forward_train(cfg, params, {k: v[:, : S // 2] for k, v in batch.items()})
        masked["labels"][:] = -1
        none = forward_train(cfg, params, masked)
    assert not torch.equal(full, half)
    torch.testing.assert_close(half, first, rtol=1e-5, atol=1e-5)  # causal: the prefix's loss
    assert float(none) == 0.0  # no valid position: the mean over max(0, 1)


def test_train_route_takes_no_kernel(monkeypatch):
    """With every tensor taken for a card's (``_on_card`` true), training
    still reaches no kernel: the route is the keyword, not the device."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention as tattention

    def no_kernel(*a, **k):
        raise AssertionError("a kernel was called on the train route")

    monkeypatch.setattr(kops, "_on_card", lambda t, use_kernel=None: True)
    monkeypatch.setattr(tattention, "flash_attention_cuda", no_kernel)
    monkeypatch.setattr(kops, "ssm_scan", no_kernel)
    for arch in ("gemma3_1b", "zamba2_2p7b", "rwkv6_1p6b"):
        cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
        params = init_params(cfg, 0, "cpu", masters=True)
        batch = _torch_batch(make_batch(cfg, np.random.default_rng(1)))
        loss, grads = _grads(params, lambda p: forward_train(cfg, p, batch))
        assert np.isfinite(loss) and all(bool(g.abs().sum() > 0) for g in grads.values()), arch
    with pytest.raises(AssertionError, match="kernel was called"):  # the serve route does
        tmodel.prefill(cfg, init_params(cfg, 0, "cpu"), {"tokens": batch["tokens"]}, max_len=S)


def test_kernels_refuse_inputs_that_need_a_gradient():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = v = torch.zeros(1, 8, 2, 16)
    x, b = torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2, 4)
    a = torch.ones(1, 8, 2, requires_grad=True)
    marker = torch.zeros(4, 4, requires_grad=True)
    calls = [lambda: fa_kernel.flash_attention_cuda(q, k, v),
             lambda: fa_kernel.flash_attention_simt(q, k, v),
             lambda: fa_kernel.flash_attention_wgmma(q, k, v),
             lambda: ss_kernel.ssm_scan_cuda(x, a, b, b),
             lambda: mr_kernel.morph_reconstruct_cuda(marker, torch.ones(4, 4))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward pass"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
            call()  # without grad mode, on to the device check
    with pytest.raises(ValueError, match="CUDA device"):  # no input needs a gradient
        fa_kernel.flash_attention_cuda(q.detach(), k, v)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced_config(tconfigs.get_config("gemma3_1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0, masters=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.setup(ttrain.parse_args(["--arch", "gemma3_1b", "--reduced"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.ones(2, np.float32)}, masters=True)


def test_train_mesh_other_than_none_raises():
    # the production mesh needs a torchrun world of 256 ranks; here there is one
    with pytest.raises(ValueError, match=r"mesh \(16, 16\) needs 256 ranks, only 1 available"):
        ttrain.setup(ttrain.parse_args(["--mesh", "single", "--device", "cpu", "--reduced"]))


def _train_args(tmp, *extra):
    return ttrain.parse_args(["--arch", "gemma3_1b", "--reduced", "--device", "cpu", "--seq", "32",
                              "--batch", "2", "--microbatches", "2", *extra]
                             + (["--ckpt-dir", str(tmp), "--ckpt-every", "2"] if tmp else []))


def test_train_resume_continues_the_uninterrupted_run(tmp_path):
    args = _train_args(None, "--steps", "4")
    whole = ttrain.run(ttrain.setup(args), args)
    first = _train_args(tmp_path, "--steps", "2")
    ttrain.run(ttrain.setup(first), first)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]
    rest = _train_args(tmp_path, "--steps", "4")
    state = ttrain.setup(rest)
    assert state["start"] == 2 and state["pipe"].step == 2
    saved = tree_mod.leaves(ttrain_checkpoint_leaves(tmp_path / "step_00000002"))
    for got, want in zip(tree_mod.leaves((state["params"], state["opt_state"])), saved):
        assert torch.equal(got, want)  # restored bit for bit
    resumed = ttrain.run(state, rest)
    assert [r["step"] for r in resumed] == [2, 3]
    for r, w in zip(resumed, whole[2:]):
        for k in ("loss", "grad_norm", "lr"):
            assert r[k] == pytest.approx(w[k], rel=1e-6), (k, r, w)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]


def ttrain_checkpoint_leaves(step_dir):
    manifest = json.loads((step_dir / "manifest.json").read_text())
    return [torch.from_numpy(np.load(step_dir / leaf["file"])) for leaf in manifest["leaves"]]


def test_train_command_line_checkpoints_and_resumes(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "rwkv6_1p6b", "--reduced",
           "--device", "cpu", "--seq", "16", "--batch", "2", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "1"]
    env = {**os.environ, "PYTHONPATH": "src"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    one = subprocess.run(cmd + ["--steps", "2"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert one.returncode == 0, one.stderr
    assert "[train] step 1 loss" in one.stdout and "resumed" not in one.stdout
    two = subprocess.run(cmd + ["--steps", "3"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert two.returncode == 0, two.stderr
    assert "[train] resumed at step 2" in two.stdout and "[train] step 2 loss" in two.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002", "step_00000003"]


_FREES_STATE = """
import gc, sys, weakref
gc.disable()  # what stays alive must be reachable, not cyclic garbage
from repro_torch import tree
from repro_torch.launch import train
args = train.parse_args(sys.argv[1:])
state = train.setup(args)
first = [weakref.ref(t) for t in tree.leaves((state["params"], state["opt_state"]))]
train.run(state, args)
last = [weakref.ref(t) for t in tree.leaves((state["params"], state["opt_state"]))]
del state
print(sum(r() is not None for r in first), sum(r() is not None for r in last))
"""


def test_train_run_frees_each_steps_old_state():
    # a fresh interpreter: the first step's lazy imports inside torch are
    # what leave its frames, and the state they hold, in a reference cycle
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _FREES_STATE, "--arch", "gemma3_1b", "--reduced", "--device",
         "cpu", "--seq", "16", "--batch", "2", "--microbatches", "2", "--steps", "2"],
        cwd=root, env={**os.environ, "PYTHONPATH": "src"}, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "0 0", out.stdout


def test_serve_command_line_decodes_and_runs_the_sa_study():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma3_1b", "--reduced",
           "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    env = {**os.environ, "PYTHONPATH": "src"}
    plain = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert plain.returncode == 0, plain.stderr
    assert "[serve] generated (2, 4)" in plain.stdout
    study = subprocess.run(cmd + ["--sa-reuse"], cwd=root, env=env, capture_output=True, text=True,
                           timeout=300)
    assert study.returncode == 0, study.stderr
    assert "[serve] SA-reuse:" in study.stdout and "/24 tasks" in study.stdout


def test_prefill_and_decode_steps_are_the_greedy_tokens():
    cfg = tconfigs.reduced_config(tconfigs.get_config("granite_moe_1b_a400m"))
    params = init_params(cfg, 0, "cpu", masters=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)))
    with torch.no_grad():
        nxt, cache = tsteps.make_prefill_step(cfg, None, max_len=12)(params, {"tokens": toks})
        logits, want_cache, _ = tmodel.prefill(cfg, tsteps.cast_for_compute(params),
                                               {"tokens": toks}, max_len=12)
        assert nxt.dtype == torch.int32 and torch.equal(nxt[:, 0], logits.argmax(-1).int())
        for k in cache:
            assert torch.equal(cache[k], want_cache[k])
        nxt2, _ = tsteps.make_decode_step(cfg, None)(params, cache, {"tokens": nxt}, 8)
        logits2, _ = tmodel.decode_step(cfg, tsteps.cast_for_compute(params), {"tokens": nxt},
                                        cache, 8)
    assert nxt2.shape == (2, 1) and torch.equal(nxt2[:, 0], logits2.argmax(-1).int())
