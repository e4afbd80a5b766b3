"""Device: the share of the profiled item in which the device was idle while
a label loop was open on some host thread: the device's idle time (outside
the union of its operations) within the union of the ``label_loop`` spans
of every thread, over the profiled item. At most ``device.idle``."""

from perfbench import harness, program_spans


def read(trace):
    lo, hi = trace.profiled
    loops = program_spans.profiled(trace, "label_loop")
    if hi <= lo or not trace.device or loops is None:
        return None
    busy = harness.union(harness.clip([(s, e) for _, s, e in trace.device], lo, hi))
    open_ = harness.union(harness.clip([(sp.start_ns, sp.end_ns) for sp in loops], lo, hi))
    return 100.0 * (_length(open_) - _overlap(open_, busy)) / (hi - lo)


def _length(intervals):
    return sum(e - s for s, e in intervals)


def _overlap(a, b):
    """Length of the intersection of two merged, sorted interval lists."""
    total, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total
