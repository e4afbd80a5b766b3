"""Device: the share of the profiled span in which no operation ran on the
device, from the union of the device's operation intervals (two streams at
once count once)."""


def read(trace):
    lo, hi = trace.profiled
    if hi <= lo or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_ns() / (hi - lo))
