"""Kernels: ``ssm_scan``'s share of its roofline in the profiled item, on a
Granite 4.0-H: the bound of every call (``rooflines/ssm_scan.bound_s``) at
the cell's prefill shapes (``batch`` sequences of ``prompt_len``, the
config's Mamba2 heads, state and head dim: N·P past what the kernel keeps in
registers) over the device time of its three passes' launches."""

from perfbench.rooflines import ssm_scan


def read(trace):
    calls = trace.kernels(ssm_scan.CALL)
    if not calls or "prompt_len" not in trace.cell:
        return None
    c, cell = trace.config, trace.cell
    h = int(c["mamba_expand"]) * int(c["hidden_size"]) // int(c["mamba_d_head"])
    bound = len(calls) * ssm_scan.bound_s(int(cell["batch"]), int(cell["prompt_len"]), h,
                                          int(c["mamba_d_state"]), int(c["mamba_d_head"]))
    return 100.0 * bound / (sum(e - s for _, s, e in trace.kernels(*ssm_scan.KERNELS)) / 1e9)
