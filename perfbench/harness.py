"""The benchmark's harness: one cell, one run.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric lives in a file of its own, found by name:

- ``workloads/<cell>.json``: the traffic mix and the configuration it runs;
- ``configs/<config>.json``: the configuration as it is run, with its
  ``driver``;
- ``drivers/<driver>.py``: a ``Driver`` class for one kind of entry;
- ``metrics/<metric>.py``: ``read(trace)`` for one per-layer metric.

The window admits whole items (calls of the entry) back to back until
``--seconds`` have passed since the first admission, then lets the item in
flight finish. Rates are over the time from the first admission to the
last completion. A traced run (``--trace 1``) wraps each task in a span
that ends with a sync of the task's own stream, and after the window runs
one more item under ``torch.profiler``, which records the device's
operations: the span metrics read the window's items, which the profiler
does not slow, and the device metrics read the profiled item.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import pathlib
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
GIB = 2**30


def load(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark's process must
    not hold (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


# -- spans -------------------------------------------------------------------


class Spans:
    """Thread-safe record of task spans: (name, layer, start_ns, end_ns),
    host wall clock, each ending after a sync of its own stream."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.records: List[Tuple[str, str, int, int]] = []

    def wrap(self, name: str, layer: str, fn):
        def run(state, *args, **kwargs):
            t0 = time.time_ns()
            out = fn(state, *args, **kwargs)
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.current_stream().synchronize()
            t1 = time.time_ns()
            with self._lock:
                self.records.append((name, layer, t0, t1))
            return out
        return run


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals: overlaps (two streams at once) count once."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Trace:
    """What a per-layer metric reads. ``spans``: (name, layer, start_ns,
    end_ns) of the window's tasks; ``items``: (start_ns, end_ns, runs) of
    every item of the window; ``counters``: the driver's counts over the
    window; ``device``: (name, start_ns, end_ns) of every device operation
    in the profiled item ``profiled`` (start_ns, end_ns), which ran after
    the window, and ``profiled_spans`` its tasks' spans."""

    def __init__(self, cell, config, spans, items, counters, n_workers, device=(),
                 profiled=(0, 0), profiled_spans=()):
        self.cell, self.config = cell, config
        self.spans, self.items, self.counters, self.n_workers = spans, items, counters, n_workers
        self.device, self.profiled, self.profiled_spans = device, profiled, profiled_spans

    @property
    def runs(self) -> int:
        return sum(r for _, _, r in self.items)

    @property
    def item_seconds(self) -> float:
        return sum(e - s for s, e, _ in self.items) / 1e9

    def task_spans(self, layer: str) -> List[Tuple[str, int, int]]:
        return [(n, s, e) for n, lay, s, e in self.spans if lay == layer]

    def kernels(self, *names: str) -> List[Tuple[str, int, int]]:
        """Device operations whose name contains one of ``names``."""
        return [k for k in self.device if any(n in k[0] for n in names)]

    def busy_ns(self) -> int:
        lo, hi = self.profiled
        return sum(e - s for s, e in union(clip([(s, e) for _, s, e in self.device], lo, hi)))


# -- the cell ---------------------------------------------------------------


def find_cell(root: pathlib.Path, name: str):
    cell = load(root / "perfbench" / "workloads" / f"{name}.json")
    config = load(root / "perfbench" / "configs" / f"{cell['config']}.json")
    driver = importlib.import_module(f"perfbench.drivers.{config['driver']}")
    return cell, config, driver


def metric_entries(root: pathlib.Path, cell_name: str, kind: str) -> List[Dict[str, Any]]:
    """The metrics of ``kind`` that ``BENCHMARK.json`` gives this cell."""
    return [m for m in load(root / "BENCHMARK.json")[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def read_metric(root: pathlib.Path, name: str, trace: Trace):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


# -- the run ----------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_events(prof) -> List[Tuple[str, int, int]]:
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
    return out


def _breakdown(trace: Trace) -> Dict[str, List[List[Any]]]:
    """The ten device operations that took most time, and idle time in the
    profiled span by the task the host was in (``outside tasks`` where it
    was in none)."""
    by_op: Dict[str, float] = {}
    for name, s, e in trace.device:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s) / 1e9
    lo, hi = trace.profiled
    busy = union(clip([(s, e) for _, s, e in trace.device], lo, hi))
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    # each gap goes to the span, of those open at its midpoint, that opened last
    spans = sorted(trace.profiled_spans, key=lambda sp: sp[2])
    names = [sp[0] for sp in spans] + ["outside tasks"]
    mids = np.array([(s + e) // 2 for s, e in gaps], dtype=np.int64)
    owner = np.full(len(gaps), len(spans), dtype=np.int64)
    for k, (_, _, t0, t1) in enumerate(spans):
        owner[np.searchsorted(mids, t0):np.searchsorted(mids, t1)] = k
    seconds = np.bincount(owner, weights=[(e - s) / 1e9 for s, e in gaps],
                          minlength=len(names))
    by_task: Dict[str, float] = {}
    for name, sec in zip(names, seconds.tolist()):
        if sec:
            by_task[name] = by_task.get(name, 0.0) + sec
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_task)}


def _profiled_item(driver, item: int, device: torch.device):
    """Runs ``item`` under ``torch.profiler``; returns its device operations
    and its (start_ns, end_ns)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        s = time.time_ns()
        driver.run_item(item)
        _sync(device)
        e = time.time_ns()
    t = time.perf_counter()
    events = _device_events(prof) if on_card else []
    print(f"perfbench: profiled item {(e - s) / 1e9:.3f} s, {len(events)} device operations "
          f"read in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    return events, (s, e)


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool,
             device: Optional[torch.device] = None, started: Optional[float] = None,
             patch=None) -> Dict[str, Any]:
    """One run of one cell; returns the result line as a dict. ``device``
    ``None`` means the card (the run refuses without one); tests pass the
    CPU. ``patch``, a context manager factory, breaks the timed path for
    the fault tests."""
    started = time.time() if started is None else started
    cell, config, driver_mod = find_cell(root, workload)
    if device is None:
        chips = int(cell.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"perfbench: needs {chips} CUDA device(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    driver = driver_mod.Driver(config, cell, seed, device)
    driver.setup()
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    spans = Spans() if trace else None
    items: List[Tuple[int, int, int]] = []
    with (patch() if patch else contextlib.nullcontext()), driver.patch(spans):
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        window_start = time.time()
        t0 = time.perf_counter()
        while not items or time.perf_counter() - t0 < seconds:
            s = time.time_ns()
            runs = driver.run_item(len(items))
            _sync(device)
            items.append((s, time.time_ns(), runs))
        window = (items[-1][1] - items[0][0]) / 1e9
        drain = time.perf_counter() - t0 - seconds
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        counters = driver.counters()
        if trace:
            events, profiled = _profiled_item(driver, len(items), device)
    runs = sum(r for _, _, r in items)

    result: Dict[str, Any] = {"correct": False, "attempted": runs, "failed": 0, "metrics": {}}
    if trace:
        in_window = [sp for sp in spans.records if sp[2] < items[-1][1]]
        tr = Trace(cell, config, in_window, items, counters, driver.n_workers, events, profiled,
                   [sp for sp in spans.records if sp[2] >= items[-1][1]])
        for entry in metric_entries(root, workload, "per_layer"):
            value = read_metric(root, entry["name"], tr)
            if value is not None:
                result["metrics"][entry["name"]] = {"value": value, "unit": entry["unit"]}
        if on_card:
            result["breakdown"] = _breakdown(tr)
    else:
        e2e = {"sa_runs_per_s": (runs / window, "runs/s"),
               "peak_device_gib": (peak / GIB, "GiB"),
               "setup_s": (window_start - started, "s")}
        for entry in metric_entries(root, workload, "end_to_end"):
            value, unit = e2e[entry["name"]]
            result["metrics"][entry["name"]] = {"value": value, "unit": unit}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": max(peak, setup_peak),
    }
    if trace and on_card:
        result["device"]["busy_s"] = tr.busy_ns() / 1e9
        result["device"]["window_s"] = (profiled[1] - profiled[0]) / 1e9
    print(f"perfbench: {workload} seed {seed}: {len(items)} items, {runs} runs in "
          f"{window:.3f} s (drain {drain:.3f} s past {seconds} s); setup "
          f"{window_start - started:.3f} s", file=sys.stderr)

    if on_card:
        torch.cuda.empty_cache()
    check_start = time.perf_counter()
    checked = driver.check()
    limits = cell["limits"]
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in checked["numbers"].items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"perfbench: compared {checked['compared']} answers of the window in "
          f"{time.perf_counter() - check_start:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv: Optional[Sequence[str]] = None, started: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once and print its "
                                             "result as the last line of standard output.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      started=started)
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"perfbench: the process holds {', '.join(leaked)}")
    print(json.dumps(result))
    return 0
