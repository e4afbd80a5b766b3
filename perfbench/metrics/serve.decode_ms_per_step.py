"""Serve: milliseconds a decode step, the window's generate tasks' time
over their steps (``gen_len`` each): the driver's spans around each
generate, each ending with a sync of its stream, so a span holds the
task's device work, its graph capture included."""


def read(trace):
    gens = [(s, e) for n, s, e in trace.task_spans("serve task") if n == "generate"]
    if not gens or "gen_len" not in trace.cell:
        return None
    return sum(e - s for s, e in gens) / 1e6 / (len(gens) * int(trace.cell["gen_len"]))
