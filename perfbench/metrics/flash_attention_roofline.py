"""Kernels: the tensor-core ``flash_attention``'s share of its roofline in
the profiled item: the bound of every launch at the cell's prefill shapes
(``batch`` sequences of ``prompt_len``, causal, the config's heads and
head dim) over the launches' device time."""

from perfbench.rooflines import flash_attention


def read(trace):
    ks = trace.kernels(*flash_attention.KERNELS)
    if not ks or "prompt_len" not in trace.cell:
        return None
    c, cell = trace.config, trace.cell
    bound = len(ks) * flash_attention.bound_s(int(cell["batch"]), int(cell["prompt_len"]),
                                              int(c["num_attention_heads"]),
                                              int(c["attention_head_dim"]))
    return 100.0 * bound / (sum(e - s for _, s, e in ks) / 1e9)
