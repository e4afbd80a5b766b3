"""Pathology tasks: the label loops' host syncs per run of the profiled
item, the ``steps`` of every ``label_loop`` span (one readback a
propagation step), the reference segmentation's loops included: the item
pays for them."""

from perfbench import program_spans


def read(trace):
    loops = program_spans.profiled(trace, "label_loop")
    runs = program_spans.profiled_runs(trace)
    if not loops or not runs:
        return None
    return sum(sp.attrs.get("steps", 0) for sp in loops) / runs
