"""Frozen copies of the program's parameter grid and samplers.

The pathology cells draw their parameter sets from Table I of the paper
(Teodoro et al., arXiv:1910.14548) with a Morris one-at-a-time trajectory
or a Halton sequence. These are copies of ``repro_torch.core.params`` and
``repro_torch.app.pipeline.TABLE1_SPACE`` as they stood when the benchmark
was written, so that a later change to the program cannot move the
yardstick. A parameter set is a tuple of (name, value) pairs sorted by
name, the form the program's planner keys on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

ParamSet = Tuple[Tuple[str, Any], ...]

# Table I: each parameter's admissible values, in pipeline order.
TABLE1: Dict[str, Tuple[Any, ...]] = {
    "B": tuple(range(210, 241, 10)),
    "G": tuple(range(210, 241, 10)),
    "R": tuple(range(210, 241, 10)),
    "T1": tuple(x / 2.0 for x in range(5, 16)),
    "T2": tuple(x / 2.0 for x in range(5, 16)),
    "G1": tuple(range(5, 81, 5)),
    "G2": tuple(range(2, 41, 2)),
    "minS": tuple(range(2, 41, 2)),
    "maxS": tuple(range(900, 1501, 50)),
    "minSPL": tuple(range(5, 81, 5)),
    "minSS": tuple(range(2, 41, 2)),
    "maxSS": tuple(range(900, 1501, 50)),
    "FH": (4, 8),
    "RC": (4, 8),
    "WConn": (4, 8),
}

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)


def paramset(d: Dict[str, Any]) -> ParamSet:
    return tuple(sorted(d.items()))


def default_set() -> ParamSet:
    """The application default: the midpoint of every grid (the Dice
    reference of every run)."""
    return paramset({k: v[len(v) // 2] for k, v in TABLE1.items()})


def quantise(u: np.ndarray) -> List[ParamSet]:
    """(n, 15) points of the unit cube onto the grid."""
    out = []
    for row in u:
        d = {}
        for (name, values), x in zip(TABLE1.items(), row):
            d[name] = values[min(int(float(x) * len(values)), len(values) - 1)]
        out.append(paramset(d))
    return out


def _radical_inverse(i: int, base: int) -> float:
    f, inv = 0.0, 1.0 / base
    while i > 0:
        f += (i % base) * inv
        i //= base
        inv /= base
    return f


def halton(n: int, *, skip: int) -> List[ParamSet]:
    """``n`` consecutive Halton points after ``skip`` (the paper's Fig. 6
    sampling), on the grid."""
    pts = np.empty((n, len(TABLE1)), dtype=np.float64)
    for j, base in enumerate(_PRIMES):
        for i in range(n):
            pts[i, j] = _radical_inverse(i + 1 + skip, base)
    return quantise(pts)


def morris(rng: np.random.Generator) -> List[ParamSet]:
    """One Morris one-at-a-time trajectory: a random grid point, then one
    parameter moved at a time by a random number of grid steps (16 runs
    over the 15 parameters)."""
    names = list(TABLE1)
    idx = {k: int(rng.integers(0, len(TABLE1[k]))) for k in names}
    cur = {k: TABLE1[k][idx[k]] for k in names}
    sets = [paramset(cur)]
    for k in rng.permutation(len(names)):
        name = names[int(k)]
        card = len(TABLE1[name])
        step = int(rng.integers(1, max(2, card // 2)))
        idx[name] = (idx[name] + step) % card
        cur[name] = TABLE1[name][idx[name]]
        sets.append(paramset(cur))
    return sets


def item_sets(traffic: Dict[str, Any]) -> List[ParamSet]:
    """The parameter sets of every item of a pathology traffic mix: one
    Morris trajectory drawn from ``design_seed`` (``{"design":
    "morris"}``), or ``points`` Halton points after ``skip`` (``{"design":
    "halton"}``). A study applies one design to every tile of its dataset,
    so every item of a run, and of every run, carries the same sets."""
    design = traffic["design"]
    if design == "morris":
        return morris(np.random.default_rng(int(traffic["design_seed"])))
    if design == "halton":
        return halton(int(traffic["points"]), skip=int(traffic["skip"]))
    raise ValueError(f"unknown design {design!r}")
