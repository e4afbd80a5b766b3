"""Pathology tasks: synced task seconds per run (the breakdown splits the
device's time by operation)."""


def read(trace):
    spans = trace.task_spans("path_task")
    if not spans or not trace.runs:
        return None
    return sum(e - s for _, s, e in spans) / 1e9 / trace.runs
