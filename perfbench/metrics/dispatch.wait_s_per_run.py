"""Manager dispatch: the seconds buckets sat in the Manager's queue per run
of the profiled item, the ``bucket.wait`` spans (from submit to lease)."""

from perfbench import program_spans


def read(trace):
    waits = program_spans.profiled(trace, "bucket.wait")
    runs = program_spans.profiled_runs(trace)
    if not waits or not runs:
        return None
    return sum(sp.end_ns - sp.start_ns for sp in waits) / 1e9 / runs
