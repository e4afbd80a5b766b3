"""The readers of the port's own spans (``repro_torch.trace``, through
``program_spans.py``): they read the profiled item alone, count two
threads' overlapping loops once, leave idle time outside every loop out,
and read nothing from a port without the tracer or an item with no device
trace."""

import importlib.util
import pathlib
import sys
import types

import pytest
import torch

from perfbench import harness, program_spans
from perfbench.tests import cells

METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"
S = 10**9  # ns a second
READERS = ("label.syncs_per_run", "dispatch.wait_s_per_run", "device.idle_in_label_loops")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_span(name, start, end, **attrs):
    return types.SimpleNamespace(name=name, layer="", start_ns=start, end_ns=end, attrs=attrs)


def study(start, end, runs=20):
    return program_span("study", start, end, tiles=1, runs=runs)


def window_and_profiled(monkeypatch, records, device=(("k", 19 * S, 20 * S),)):
    """A trace whose window is 0-10 s (one item of 20 runs) and whose
    profiled item is 10-20 s, with ``records`` as the port's spans."""
    monkeypatch.setattr(program_spans, "_records", lambda: list(records))
    return harness.Trace({}, {"tile": 4096}, [], [(0, 10 * S, 20)], {}, 2, list(device),
                         (10 * S, 20 * S), [])


def test_two_threads_overlapping_loops_count_once(monkeypatch):
    # thread A's loop 11-15 s, thread B's 13-17 s: open 11-17 s; device busy 12-14 s
    loops = [study(10 * S, 20 * S), program_span("label_loop", 11 * S, 15 * S, steps=3),
             program_span("label_loop", 13 * S, 17 * S, steps=4)]
    tr = window_and_profiled(monkeypatch, loops, [("k", 12 * S, 14 * S)])
    assert reader("device.idle_in_label_loops")(tr) == pytest.approx(100 * 4 / 10)
    assert reader("device.idle_in_label_loops")(tr) <= reader("device.idle")(tr)
    assert reader("label.syncs_per_run")(tr) == pytest.approx(7 / 20)


def test_idle_outside_every_loop_is_not_counted(monkeypatch):
    # idle 10-12 s and 14-20 s; the one loop, 12-15 s, is idle for 1 s of it
    tr = window_and_profiled(monkeypatch, [program_span("label_loop", 12 * S, 15 * S)],
                             [("k", 12 * S, 14 * S)])
    assert reader("device.idle")(tr) == pytest.approx(80.0)
    assert reader("device.idle_in_label_loops")(tr) == pytest.approx(10.0)
    tr = window_and_profiled(monkeypatch, [], [("k", 12 * S, 14 * S)])
    assert reader("device.idle_in_label_loops")(tr) == 0.0


def test_only_the_profiled_items_spans_are_read(monkeypatch):
    records = [study(0, 10 * S), program_span("label_loop", 1 * S, 2 * S, steps=1000),
               program_span("bucket.wait", 0, 9 * S),  # the window's: left out
               study(10 * S, 20 * S, runs=10),
               program_span("label_loop", 11 * S, 12 * S, steps=30),
               program_span("label_loop", 13 * S, 19 * S, steps=10),
               program_span("bucket.wait", 10 * S, 12 * S),
               program_span("bucket.wait", 15 * S, 16 * S)]
    tr = window_and_profiled(monkeypatch, records)
    assert program_spans.profiled_runs(tr) == 10
    assert reader("label.syncs_per_run")(tr) == pytest.approx(40 / 10)
    assert reader("dispatch.wait_s_per_run")(tr) == pytest.approx(3 / 10)


def test_an_item_without_a_device_trace_reads_nothing(monkeypatch):
    records = [study(10 * S, 20 * S), program_span("label_loop", 11 * S, 12 * S, steps=3),
               program_span("bucket.wait", 10 * S, 12 * S)]
    tr = window_and_profiled(monkeypatch, records, device=())
    assert all(reader(name)(tr) is None for name in READERS)


def test_a_port_without_the_tracer_reads_nothing(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)  # its import raises ImportError
    tr = harness.Trace({}, {"tile": 4096}, [], [(0, 10 * S, 20)], {}, 2, [("k", 0, S)],
                       (10 * S, 20 * S), [])
    assert all(reader(name)(tr) is None for name in READERS)


@pytest.mark.parametrize("cell", sorted(cells.CELLS))
def test_a_traced_run_records_the_profiled_item_alone(tmp_path, monkeypatch, cell):
    """A traced run of a tiny cell on the CPU: the port records one study,
    the profiled item's, and none of the warm call's or the window's; given
    device operations over that item, the readers read it."""
    from repro_torch import trace

    root = cells.write(tmp_path, with_metrics=True)
    seen = []

    class Spy(harness.Trace):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(harness, "Trace", Spy)
    started = trace.now_ns()  # records of earlier profiles stay until recording() clears them
    result = harness.run_cell(root, cell, 2**31 + 105, 0.0, True, device=torch.device("cpu"))
    assert result["correct"] is True
    assert not set(READERS) & set(result["metrics"])  # no device trace on the CPU
    (tr,) = seen
    spans = [sp for sp in trace.records() if sp.start_ns >= started]
    (root_span,) = [sp for sp in spans if sp.name == "study"]
    assert all(sp.start_ns >= tr.profiled[0] and sp.study == root_span.id for sp in spans)
    tr.device = [("k", tr.profiled[0], tr.profiled[0] + 1)]
    assert program_spans.profiled_runs(tr) == tr.items[-1][2]
    assert reader("label.syncs_per_run")(tr) > 0
    assert reader("dispatch.wait_s_per_run")(tr) > 0
    assert 0 < reader("device.idle_in_label_loops")(tr) <= reader("device.idle")(tr)
