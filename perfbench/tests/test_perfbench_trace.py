"""The reduction from spans and device operations to per-layer metrics,
and the yardstick's bound at the real shape."""

import importlib.util
import pathlib

import pytest

from perfbench import harness
from perfbench.rooflines import morph_recon

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"
S = 10**9  # ns a second


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def trace(device, spans=(), items=((0, 10 * S, 20),), config=None, counters=None):
    return harness.Trace({}, config or {"tile": 4096}, list(spans), list(items),
                         counters or {"tasks_executed": 90}, 2, list(device), (0, 10 * S),
                         list(spans))


def test_union_counts_two_overlapping_streams_once():
    # stream A busy 0-4 s, stream B busy 2-6 s and 8-9 s
    ops = [("a", 0, 4 * S), ("b", 2 * S, 6 * S), ("b", 8 * S, 9 * S)]
    assert harness.union([(s, e) for _, s, e in ops]) == [(0, 6 * S), (8 * S, 9 * S)]
    tr = trace(ops)
    assert tr.busy_ns() == 7 * S
    assert reader("device.idle")(tr) == pytest.approx(30.0)
    # summing kernel times would read 1 - 9/10: the double count this avoids
    assert reader("device.idle")(trace([])) is None


def test_union_clips_to_the_profiled_span():
    tr = trace([("a", -2 * S, 1 * S), ("a", 9 * S, 12 * S)])
    assert tr.busy_ns() == 2 * S


def test_breakdown_attributes_idle_to_the_open_task():
    ops = [("k1", 0, 2 * S), ("k2", 3 * S, 4 * S), ("k1", 6 * S, 10 * S)]
    spans = [("watershed", "path_task", 1 * S, 5 * S), ("area_pre", "path_task", 2 * S, 4 * S)]
    b = harness._breakdown(trace(ops, spans))
    assert b["device_ops"] == [["k1", 6.0], ["k2", 1.0]]
    # gap 2-3 s: area_pre opened last; gap 4-6 s (midpoint 5 s): outside every span
    assert dict(b["idle_gaps"]) == {"area_pre": 1.0, "outside tasks": 2.0}


def test_span_readers():
    spans = [("watershed", "path_task", 0, 4 * S), ("recon", "path_task", 4 * S, 6 * S),
             ("area_pre", "path_task", 0, 3 * S)]
    tr = trace([], spans)
    assert reader("planner.tasks_per_run")(tr) == pytest.approx(4.5)
    assert reader("dispatch.efficiency")(tr) == pytest.approx(100 * 9 / (10 * 2))
    assert reader("tasks.path_s_per_run")(tr) == pytest.approx(9 / 20)


def test_roofline_readers():
    ms = 10**6
    tr = trace([("void recon_kernel(Params)", 0, 2 * ms), ("recon_kernel", 3 * ms, 4 * ms)])
    assert reader("morph_recon_roofline")(tr) == pytest.approx(
        100 * 2 * morph_recon.bound_s(4096 * 4096) / 3e-3)
    assert reader("morph_recon_roofline")(trace(tr.device, config={"driver": "x"})) is None


def test_bound_at_the_real_shape():
    """The bound the program's card checks print for Seg2 at 4096² (bytes)."""
    assert round(morph_recon.bound_s(4096 * 4096) * 1e3, 4) == 0.0601
