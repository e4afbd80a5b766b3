"""Where a training step's time goes, on the card: ``chip_smoke.py``
phase 24's step (gemma3_1b at full width, fp32 masters, sequence 4096, 2
microbatches of one sequence, the launcher's OptConfig), then its parts
alone, each timed by CUDA events after a warm-up:

- the whole step (``launch.steps.make_train_step``), three times;
- attention, ``blocked_attention(train=True)`` at (1, 4096, 4, 256) with
  kv 1: one forward, and one forward with its backward; a step runs 26
  layers × 2 microbatches of forward, recompute and backward;
- the LM head and the cross-entropy over the padded vocab, forward and
  backward, for one microbatch;
- ``adamw_update`` over the 1.30 B masters;

and, under ``torch.profiler`` (CUDA activity), one step's device time by
kernel, and the device's busy share: the union of its operations'
intervals against the step's wall time.

    python3 tools/profile_train.py    # needs a CUDA card
"""

from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch.steps import cast_for_compute, make_train_step  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.attention import blocked_attention  # noqa: E402
from repro_torch.models.layers import COMPUTE_DTYPE, cross_entropy, matmul  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init, adamw_update  # noqa: E402

SEQ, BATCH, MICRO = 4096, 2, 2
DEVICE = "cuda:0"


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def busy_ms(prof) -> float:
    """The time in which some operation ran on the card: the union of the
    device operations' intervals, so two streams at once count once (a sum
    of the kernels' times would count them twice)."""
    from torch.autograd import DeviceType

    spans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    cfg = configs.get_config("gemma3_1b")
    dev = torch.device(DEVICE)
    params = init_params(cfg, 0, dev, masters=True)
    state = adamw_init(params)
    shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=SEQ, global_batch=BATCH)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(cfg, shape).batch_at(0).items()}
    holder = {"p": params, "s": state}
    parts = {}

    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, SEQ, cfg.num_heads, cfg.head_dim, generator=gen, device=dev).to(COMPUTE_DTYPE)
    k, v = (torch.randn(1, SEQ, cfg.num_kv_heads, cfg.head_dim, generator=gen, device=dev)
            .to(COMPUTE_DTYPE) for _ in range(2))
    qkv = [t.requires_grad_(True) for t in (q, k, v)]

    def attn_fwd():
        with torch.no_grad():
            blocked_attention(*qkv, window=SEQ, train=True)

    def attn_fwd_bwd():
        o = blocked_attention(*qkv, window=SEQ, train=True)
        torch.autograd.grad(o, qkv, grad_outputs=torch.ones_like(o))

    fwd_ms, fb_ms = events_ms(attn_fwd, 3), events_ms(attn_fwd_bwd, 3)
    calls = cfg.num_layers * MICRO  # forward, recompute and backward for each
    parts["attention"] = calls * (fwd_ms + fb_ms)
    print(f"attention (1,{SEQ},{cfg.num_heads},{cfg.head_dim}) kv {cfg.num_kv_heads}: forward "
          f"{fwd_ms:.2f} ms, forward+backward {fb_ms:.2f} ms; {calls} layer-microbatches a step")
    del q, k, v, qkv
    torch.cuda.empty_cache()

    x = torch.randn(1, SEQ, cfg.d_model, generator=gen, device=dev).to(COMPUTE_DTYPE).requires_grad_(True)
    head = params["lm_head"].detach().requires_grad_(True)
    labels = batch["labels"][:1].long()

    def head_ce():
        loss = cross_entropy(matmul(x, head), labels, valid=labels >= 0, vocab_size=cfg.vocab_size)
        torch.autograd.grad(loss, [x, head])

    ce_ms = events_ms(head_ce, 3)
    parts["LM head + cross-entropy"] = MICRO * ce_ms
    print(f"LM head + cross-entropy, forward+backward, one microbatch: {ce_ms:.1f} ms")
    del x, head
    torch.cuda.empty_cache()

    grads = tree_mod.tree_map(lambda p: torch.full_like(p, 1e-3), params)
    opt_ms = events_ms(lambda: adamw_update(grads, state, params, OptConfig()), 3)
    parts["adamw_update"] = opt_ms
    print(f"adamw_update over {sum(t.numel() for t in tree_mod.leaves(params))} masters: "
          f"{opt_ms:.1f} ms")
    del grads
    torch.cuda.empty_cache()
    cast_ms = events_ms(lambda: cast_for_compute(params), 3)
    parts["cast_for_compute"] = MICRO * cast_ms
    print(f"cast_for_compute: {cast_ms:.1f} ms a call, {MICRO} a step")
    torch.cuda.empty_cache()

    step = make_train_step(cfg, None, OptConfig(), microbatches=MICRO)
    del params, state

    def one_step():
        holder["p"], holder["s"], _ = step(holder["p"], holder["s"], batch)

    step_ms = events_ms(one_step, 3)
    print(f"train step: {step_ms:.1f} ms ({BATCH * SEQ / step_ms * 1e3:.0f} tokens/s); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, ms in parts.items():
        print(f"  {name}: {ms:.0f} ms a step ({ms / step_ms:.1%})")
    rest = step_ms - sum(parts.values())
    print(f"  the rest (the layers' bf16 products, norms, embedding, recompute bookkeeping): "
          f"{rest:.0f} ms ({rest / step_ms:.1%})")

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        one_step()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy = busy_ms(prof)
    if not kernels:
        print("device busy share: not measured (the profiler recorded no device time)")
    else:
        print(f"one step under the profiler: {wall:.1f} ms wall (CUDA events), {busy:.1f} ms in "
              f"which a kernel ran: busy {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / 1e3:9.1f} ms  {e.count:6d} calls  {e.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
