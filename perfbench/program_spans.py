"""The port's own spans (``repro_torch.trace``) in the profiled item.

The port records its spans while ``torch.profiler`` is on, so a traced
run holds them for the item the harness profiles after the window, and
for nothing else. The readers split them by start time as the harness
splits its spans: the profiled item's started at or after its start.
Three readers take them from here: ``label.syncs_per_run`` (the ``steps``
of the ``label_loop`` spans, one host sync each, over the item's runs),
``dispatch.wait_s_per_run`` (the ``bucket.wait`` spans, a bucket's time in
the Manager's queue, over the item's runs) and
``device.idle_in_label_loops`` (the device's idle time inside the union of
every thread's ``label_loop`` spans, over the item). The item's runs are
the ``runs`` of its ``study`` spans. Where the item kept no device
operations (a run on the CPU), or the port has no tracer, they read
nothing."""

from __future__ import annotations


def _records():
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.records()


def profiled(trace, name):
    """The spans called ``name`` that started in the profiled item, or
    ``None`` where there is nothing to read."""
    recs = _records()
    if recs is None or not trace.device:
        return None
    return [sp for sp in recs if sp.name == name and sp.start_ns >= trace.profiled[0]]


def profiled_runs(trace):
    """The runs of the profiled item's studies."""
    return sum(sp.attrs.get("runs", 0) for sp in profiled(trace, "study") or ())
