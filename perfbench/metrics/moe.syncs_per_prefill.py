"""MoE: the host syncs of the profiled item's dropless MoE dispatches (the
``syncs`` of its ``moe.dispatch`` spans, one read of the experts' loads
each) over its prefills (``serve.prefill`` spans). A program without the
span reads nothing."""

from perfbench import program_spans


def read(trace):
    dispatches = program_spans.profiled(trace, "moe.dispatch")
    prefills = program_spans.profiled(trace, "serve.prefill")
    if not dispatches or not prefills:
        return None
    return sum(sp.attrs.get("syncs", 0) for sp in dispatches) / len(prefills)
