"""Device: the share of the profiled item in which the device was idle
while a prefill task (the driver's span around it, ending with a sync of
its stream) was open: the device's idle time (outside the union of its
operations) within the union of those spans, over the profiled item. The
dropless MoE's host reads of its experts' loads stall the card here."""

from perfbench import harness, serve_spans


def read(trace):
    lo, hi = trace.profiled
    tasks = [(s, e) for n, lay, s, e in trace.profiled_spans
             if lay == "serve task" and n == "prefill"]
    if hi <= lo or not trace.device or not tasks:
        return None
    busy = harness.union(harness.clip([(s, e) for _, s, e in trace.device], lo, hi))
    open_ = harness.union(harness.clip(tasks, lo, hi))
    return 100.0 * (serve_spans.length(open_) - serve_spans.overlap(open_, busy)) / (hi - lo)
