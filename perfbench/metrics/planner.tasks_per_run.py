"""Planner: the tasks the entry executed (its measured count, after the
planner's merging and the result cache's hits) per run of the window."""


def read(trace):
    executed = trace.counters.get("tasks_executed")
    return executed / trace.runs if executed is not None and trace.runs else None
