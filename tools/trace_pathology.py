"""The port's tracer on a pathology cell's items, on the card:

- its cost: pairs of items of ``run_dataset_study`` over the same tiles of
  the cell (the benchmark's driver builds them), one with
  ``trace.recording()`` off and one on, which goes first alternating, and
  the median item seconds of each side;
- where the device idles: one more item with tracing on under
  ``torch.profiler`` (CUDA activity), its idle time (outside the union of
  the device's operations) split by the innermost span open on any thread
  at each instant (the deepest in the span tree; a ``label_loop`` named
  with its task), with the spans' counts: label-loop syncs, bucket waits,
  and buckets that ran more than once (straggler backups); and the host
  time of one empty span, off and on;
- the label loops' kernel (``kernels/label_prop``): its launches and the
  steps it counted on the card over the profiled item; then, by task, the
  same item's loops once more with each launch waited for and its steps
  read (a lock around each launch, so that the two workers' steps stay
  apart), and once with the Python loops (one host sync a step), whose
  syncs the kernel's steps equal;
- the component-sizes kernel (``kernels/component_sizes``): its launches
  and its two kernels' device seconds over the profiled item, and its
  calls by task from the ``component_sizes`` spans, beside the label
  kernel's.

    python3 tools/trace_pathology.py --workload path4k.moat --pairs 5   # needs a CUDA card

Prints one JSON line last; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import statistics
import sys
import threading
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import plain_label_loops  # noqa: E402
from perfbench import harness  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.kernels import component_sizes as sizes_kernel, label_prop  # noqa: E402


def idle_by_span(device, spans, lo, hi):
    """Seconds of [lo, hi] in which no device operation ran, by the
    innermost span open then (``outside spans`` where none was)."""
    busy = harness.union(harness.clip([(s, e) for _, s, e in device], lo, hi))
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    by_id = {sp.id: sp for sp in spans}

    def depth(sp):
        d = 0
        while sp.parent in by_id:
            sp, d = by_id[sp.parent], d + 1
        return d

    def label(sp):
        if sp.name == "label_loop" and sp.parent in by_id:
            return f"label_loop ({by_id[sp.parent].name})"
        return sp.name

    # sweep the gaps and the spans' ends in time order
    events = sorted([(sp.start_ns, 1, sp) for sp in spans] + [(sp.end_ns, 0, sp) for sp in spans],
                    key=lambda ev: (ev[0], ev[1]))
    rank = {sp.id: (depth(sp), sp.start_ns) for sp in spans}
    out: dict = collections.defaultdict(float)
    open_: dict = {}
    k = 0
    for g0, g1 in gaps:
        t = g0
        while True:
            while k < len(events) and events[k][0] <= t:
                _, starts, sp = events[k]
                if starts:
                    open_[sp.id] = sp
                else:
                    open_.pop(sp.id, None)
                k += 1
            nxt = min(g1, events[k][0]) if k < len(events) else g1
            if nxt > t:
                owner = max(open_.values(), key=lambda sp: rank[sp.id]) if open_ else None
                out[label(owner) if owner else "outside spans"] += (nxt - t) / 1e9
            if nxt >= g1:
                break
            t = nxt
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_cost_us(n=100_000):
    """Microseconds of host time one empty span costs, off and on."""
    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("x", "cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = loop()
    with trace.recording():
        on = loop()
    return off, on


def counts_by_task(spans, name="label_loop", extra=None):
    """The spans called ``name`` (``calls``) and their counts summed (a
    ``label_loop``'s host syncs, ``steps``, and kernel ``launches``; a
    ``component_sizes``' ``launches``) by their task span's name, with
    ``extra`` ({span id: {name: count}}) added to each span's task."""
    by_id = {sp.id: sp for sp in spans}
    out: dict = collections.defaultdict(collections.Counter)
    for sp in spans:
        if sp.name != name:
            continue
        task = out[by_id[sp.parent].name if sp.parent in by_id else "?"]
        task["calls"] += 1
        task.update(sp.attrs)
        task.update((extra or {}).get(sp.id, {}))
    return {k: dict(v) for k, v in sorted(out.items())}


def kernel_steps_by_task(driver, item, sync):
    """The item once more, each launch of the label loops' kernel waited
    for and the steps it counted on the card read, under one lock (the two
    workers' launches one at a time), by its ``label_loop`` span."""
    lock = threading.Lock()
    steps: dict = collections.defaultdict(collections.Counter)
    wrapped = {}

    def counted(fn):
        def call(*args, **kw):
            with lock:
                sync()
                before = label_prop.STEPS.value
                out = fn(*args, **kw)
                sync()
                steps[trace.current().id]["device_steps"] += label_prop.STEPS.value - before
            return out
        return call

    for name in ("label_components_cuda", "flood_cuda"):
        wrapped[name] = getattr(label_prop, name)
        setattr(label_prop, name, counted(wrapped[name]))
    try:
        with trace.recording():
            driver.run_item(item)
            sync()
    finally:
        for name, fn in wrapped.items():
            setattr(label_prop, name, fn)
    return counts_by_task(trace.records(), extra=steps)


def python_loops_by_task(driver, item, sync):
    """The item once more with the label loops' Python versions on the
    card (one host sync a step)."""
    with plain_label_loops(), trace.recording():
        driver.run_item(item)
        sync()
    return counts_by_task(trace.records())


def measure(root, workload, pairs, seed, device):
    """The cost and the profiled item's split (see the module docstring)."""
    cell, config, mod = harness.find_cell(root, workload)
    driver = mod.Driver(config, cell, seed, device)
    driver.setup()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    seconds = {False: [], True: []}
    for j in range(pairs):  # both sides of a pair run the same entry of the dataset
        for on in ((False, True) if j % 2 == 0 else (True, False)):
            sync()
            t0 = time.perf_counter()
            with trace.recording() if on else contextlib.nullcontext():
                driver.run_item(j)
                sync()
            seconds[on].append(time.perf_counter() - t0)
    off, on = statistics.median(seconds[False]), statistics.median(seconds[True])

    from torch.profiler import ProfilerActivity, profile

    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    sync()
    launches0, steps0 = label_prop.LAUNCHES.value, label_prop.STEPS.value
    sizes0 = sizes_kernel.LAUNCHES.value
    with profile(activities=[activity]) as prof:
        with trace.recording():
            lo = time.time_ns()
            runs = driver.run_item(pairs)
            sync()
            hi = time.time_ns()
    kernel = {"launches": label_prop.LAUNCHES.value - launches0,
              "steps": label_prop.STEPS.value - steps0}
    device_ops = harness._device_events(prof) if device.type == "cuda" else []
    sizes = {"launches": sizes_kernel.LAUNCHES.value - sizes0,
             "device_s": {k: sum(e - s for name, s, e in device_ops if k in name) / 1e9
                          for k in ("count_kernel", "lookup_kernel")}}
    spans = trace.records()
    cost_off_us, cost_on_us = span_cost_us()
    runs_per_key = collections.defaultdict(list)
    for sp in spans:
        if sp.name == "bucket.run":
            runs_per_key[(sp.parent, sp.attrs.get("key"))].append(sp)
    loops = [sp for sp in spans if sp.name == "label_loop"]
    by_id = {sp.id: sp for sp in spans}
    by_task = counts_by_task(spans)
    busy = sum(e - s for s, e in harness.union(harness.clip(
        [(s, e) for _, s, e in device_ops], lo, hi)))
    return {
        "workload": workload, "seed": seed,
        "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "item_s_off": seconds[False], "item_s_on": seconds[True],
        "median_off": off, "median_on": on, "cost": on / off - 1,
        "profiled_item_s": (hi - lo) / 1e9, "runs": runs,
        "device_idle_share": 1 - busy / (hi - lo),
        "idle_s_by_innermost_span": idle_by_span(device_ops, spans, lo, hi),
        "label_loops_by_task": by_task,
        "label_kernel": kernel,
        "component_sizes_kernel": sizes,
        "component_sizes_by_task": counts_by_task(spans, "component_sizes"),
        "label_kernel_steps_by_task": kernel_steps_by_task(driver, pairs, sync),
        "python_label_loops_by_task": python_loops_by_task(driver, pairs, sync),
        "syncs_per_run": sum(sp.attrs.get("steps", 0) for sp in loops) / runs,
        "bucket_wait_s": sum(sp.end_ns - sp.start_ns for sp in spans
                             if sp.name == "bucket.wait") / 1e9,
        "buckets": len(runs_per_key),
        # a bucket leased more than once: each lease's span, its session's name,
        # its seconds and the tasks it executed and found in the cache
        "buckets_run_twice_or_more": [
            [{"under": by_id[sp.parent].name if sp.parent in by_id else "?", "key": key,
              "start_s": (sp.start_ns - lo) / 1e9, "s": (sp.end_ns - sp.start_ns) / 1e9,
              "executed": sp.attrs.get("executed"), "hits": sp.attrs.get("hits")}
             for sp in runs]
            for (_, key), runs in runs_per_key.items() if len(runs) > 1],
        "spans": len(spans),
        "span_us_off": cost_off_us, "span_us_on": cost_on_us,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="path4k.moat")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2**31 + 25)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_pathology: needs a CUDA card")
    line = json.dumps(measure(ROOT, args.workload, args.pairs, args.seed,
                              torch.device("cuda", 0)))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
