"""Manager dispatch: the paper's parallel efficiency, busy / (makespan ×
workers), with busy the sum of the synced task spans and makespan the
items' time."""


def read(trace):
    busy = sum(e - s for _, _, s, e in trace.spans) / 1e9
    if not busy or not trace.item_seconds:
        return None
    return 100.0 * busy / (trace.item_seconds * trace.n_workers)
