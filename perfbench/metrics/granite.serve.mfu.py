"""Serve: the profiled item's active model operations over its time at the
card's bf16 dense peak, on a Granite 4.0-H: every prefill (the ``tokens``
and ``batch`` of its ``serve.prefill`` span) and every decode step (the
``steps`` of each ``serve.generate`` span, step i's queries against
``prompt_len`` + i + 1 cached positions), counted by
``rooflines/granite_hybrid_flops.py`` (the experts a token takes, not those
a decode step reads)."""

from perfbench import program_spans
from perfbench.rooflines import granite_hybrid_flops
from perfbench.rooflines.tensor_peaks import BF16_OPS_PER_S


def read(trace):
    lo, hi = trace.profiled
    prefills = program_spans.profiled(trace, "serve.prefill")
    generates = program_spans.profiled(trace, "serve.generate")
    if hi <= lo or not prefills or "prompt_len" not in trace.cell:
        return None
    c, batch, prompt = trace.config, int(trace.cell["batch"]), int(trace.cell["prompt_len"])
    ops = sum(granite_hybrid_flops.prefill_flops(c, sp.attrs["batch"],
                                                 sp.attrs["tokens"] // sp.attrs["batch"])
              for sp in prefills)
    for sp in generates or ():
        ops += sum(granite_hybrid_flops.decode_flops(c, batch, prompt + i + 1)
                   for i in range(sp.attrs["steps"]))
    return 100.0 * ops / ((hi - lo) / 1e9 * BF16_OPS_PER_S)
