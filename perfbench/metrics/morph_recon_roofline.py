"""Kernels: ``morph_recon``'s share of its roofline in the profiled span:
the byte bound of every launch at the tile's size over the launches'
device time."""

from perfbench.rooflines import morph_recon


def read(trace):
    ks = trace.kernels(*morph_recon.KERNELS)
    if not ks or "tile" not in trace.config:
        return None
    bound = len(ks) * morph_recon.bound_s(trace.config["tile"] ** 2)
    return 100.0 * bound / (sum(e - s for _, s, e in ks) / 1e9)
