"""Where a Zamba2-7B serve item's time goes, on the card: one prefill at the
``zamba2_7b.serve_sa`` cell's shapes (8 sequences of 3584 tokens, caches
of 3648 positions) and ``--steps`` decode steps after it, each under
``torch.profiler`` (CPU and CUDA activity), with the model's parts
wrapped in ``record_function`` ranges: the shared blocks' attention
(``decode_attention`` / ``blocked_attention``), their q/k/v and MLP
projections, and the Mamba2 layers (a decode step replays a CUDA graph,
so the ranges show for prefill only). Prints, for prefill, for one
decode step and for a later generate's first step (a new decoder: two
cache sets, a warm-up step, two graph captures, then its first step; the
process's one-time costs paid by the first): the wall time without the profiler and under
it, the device's busy share (the union of its operations' intervals over
that time), each range's host time and its kernels' device time, and the
ten kernels that took most device time.

    python3 tools/profile_serve.py [--steps 4]    # needs a CUDA card
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import zamba2_7b  # noqa: E402
from repro_torch.models import decoder, init_params, prefill, ssm, zamba2  # noqa: E402

BATCH, PROMPT, MAX_LEN = 8, 3584, 3648
# (module, attribute, range name)
RANGES = ((zamba2, "blocked_attention", "attention"), (zamba2, "decode_attention", "attention"),
          (zamba2, "_qkv", "shared q/k/v"), (zamba2, "_mlp", "shared MLP"),
          (ssm, "mamba2_grouped_block", "mamba2"), (ssm, "mamba2_grouped_decode", "mamba2"))


@contextlib.contextmanager
def ranges():
    """Each of RANGES wrapped in a ``record_function`` of its name."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in RANGES]
    for (mod, attr, name), (_, _, fn) in zip(RANGES, saved):
        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)
        setattr(mod, attr, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _cuda(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def busy_s(prof) -> float:
    """The union of the device operations' intervals, in seconds (the
    ranges' own device-side spans left out: they cover the gaps)."""
    names = {n for _, _, n in RANGES}
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if _cuda(e) and e.name not in names)
    total, cur = 0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            total += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return (total + (cur[1] - cur[0] if cur else 0)) / 1e6


def report(label: str, prof, wall: float, per: int = 1) -> None:
    """Host wall time, device busy time and share, each range's host time,
    its kernels' device time and its device-side span (first kernel's
    start to last kernel's end, gaps included), and the top kernels."""
    busy = busy_s(prof)
    names = {n for _, _, n in RANGES}
    kernels = [e for e in prof.events() if _cuda(e) and e.name not in names]
    print(f"{label}: host {wall / per * 1e3:.1f} ms, device busy {busy / per * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f}%), {len(kernels) // per} device operations")
    for name in dict.fromkeys(n for _, _, n in RANGES):
        cpu = [e for e in prof.events() if e.name == name and not _cuda(e)]
        gpu = [e for e in prof.events() if e.name == name and _cuda(e)]
        if cpu:
            print(f"  range {name:14s} host {sum(e.cpu_time_total for e in cpu) / per / 1e3:8.2f} ms,"
                  f" kernels {sum(e.device_time_total for e in cpu) / per / 1e3:8.2f} ms,"
                  f" span {sum(e.time_range.elapsed_us() for e in gpu) / per / 1e3:8.2f} ms,"
                  f" calls {len(cpu) // per}")
    by = {}
    for e in kernels:
        by.setdefault(e.name, [0.0, 0])
        by[e.name][0] += e.time_range.elapsed_us()
        by[e.name][1] += 1
    for name, (us, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {us / per / 1e3:9.2f} ms  x{n // per:<6d} {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = zamba2_7b.CONFIG
    gen = torch.Generator(device=dev).manual_seed(1)
    params = init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
    logits, cache, n = prefill(cfg, params, {"tokens": tokens}, MAX_LEN)  # warm
    nxt = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    dec = decoder(cfg, params, cache)  # captures the graphs
    dec.step({"tokens": nxt}, n)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoder(cfg, params, cache).step({"tokens": nxt}, n)  # a new decoder, as a generate starts
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    t0 = time.perf_counter()
    prefill(cfg, params, {"tokens": tokens}, MAX_LEN)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(args.steps):
        dec.step({"tokens": nxt}, n + 1 + i)
    torch.cuda.synchronize()
    print(f"without the profiler: prefill {(t1 - t0) * 1e3:.1f} ms, first decode step (with "
          f"the capture) {first * 1e3:.1f} ms, a later generate's first step {again * 1e3:.1f} "
          f"ms, decode step {(time.perf_counter() - t1) / args.steps * 1e3:.1f} ms")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with ranges():
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache, n = prefill(cfg, params, {"tokens": tokens}, MAX_LEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("prefill (8 x 3584)", prof, wall)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(args.steps):
                dec.step({"tokens": nxt}, n + 1 + args.steps + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"decode step (mean of {args.steps})", prof, wall, args.steps)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decoder(cfg, params, cache).step({"tokens": nxt}, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("a later generate's first step", prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
