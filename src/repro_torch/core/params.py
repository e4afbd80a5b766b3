"""Parameter spaces and sampling strategies for sensitivity analysis.

The paper (§II-A) selects parameter-value sets with Monte-Carlo, Latin
hypercube (LHS), or quasi-Monte-Carlo (Halton / Hammersley) sampling, feeding
screening (Morris One-At-A-Time) or variance-based (VBD) SA methods.

Parameters here are *discrete grids* (Table I of the paper): each parameter
has an ordered list of admissible values. Samplers draw points in [0,1)^d and
quantise onto the grid, mirroring how the paper's SA tooling (Dakota-style)
drives a grid-valued application.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "Param",
    "ParamSpace",
    "ParamSet",
    "halton_sequence",
    "hammersley_sequence",
    "latin_hypercube",
    "monte_carlo",
    "morris_trajectories",
]


@dataclasses.dataclass(frozen=True)
class Param:
    """A single application parameter with its admissible grid of values."""

    name: str
    values: Tuple[Any, ...]

    def __post_init__(self) -> None:
        if len(self.values) == 0:
            raise ValueError(f"parameter {self.name!r} has an empty grid")

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def quantise(self, u: float) -> Any:
        """Map u in [0,1) onto the grid."""
        idx = min(int(u * len(self.values)), len(self.values) - 1)
        return self.values[idx]


# A ParamSet is an immutable mapping parameter-name -> chosen value.
ParamSet = Tuple[Tuple[str, Any], ...]


def paramset(d: Dict[str, Any]) -> ParamSet:
    return tuple(sorted(d.items()))


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """An ordered collection of :class:`Param`."""

    params: Tuple[Param, ...]

    @classmethod
    def from_dict(cls, d: Dict[str, Sequence[Any]]) -> "ParamSpace":
        return cls(tuple(Param(k, tuple(v)) for k, v in d.items()))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    @property
    def dim(self) -> int:
        return len(self.params)

    def quantise(self, u: np.ndarray) -> List[ParamSet]:
        """Quantise an (n, dim) array of unit-cube points onto the grid."""
        if u.ndim != 2 or u.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) points, got {u.shape}")
        out: List[ParamSet] = []
        for row in u:
            out.append(
                tuple(
                    sorted(
                        (p.name, p.quantise(float(x)))
                        for p, x in zip(self.params, row)
                    )
                )
            )
        return out

    def default(self) -> ParamSet:
        """The application default: midpoint of every grid (paper §II-A uses
        the default-parameter segmentation as the Dice reference)."""
        return tuple(
            sorted((p.name, p.values[len(p.values) // 2]) for p in self.params)
        )


# ---------------------------------------------------------------------------
# Low-discrepancy / random samplers
# ---------------------------------------------------------------------------

_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
]


def _radical_inverse(i: int, base: int) -> float:
    f, inv = 0.0, 1.0 / base
    while i > 0:
        f += (i % base) * inv
        i //= base
        inv /= base
    return f


def halton_sequence(n: int, dim: int, *, skip: int = 20) -> np.ndarray:
    """Halton quasi-Monte-Carlo sequence (the paper's Fig 6 sampling)."""
    if dim > len(_PRIMES):
        raise ValueError(f"halton supports up to {len(_PRIMES)} dims")
    pts = np.empty((n, dim), dtype=np.float64)
    for j in range(dim):
        b = _PRIMES[j]
        for i in range(n):
            pts[i, j] = _radical_inverse(i + 1 + skip, b)
    return pts


def hammersley_sequence(n: int, dim: int) -> np.ndarray:
    """Hammersley set: first coordinate i/n, rest radical inverses."""
    pts = np.empty((n, dim), dtype=np.float64)
    pts[:, 0] = (np.arange(n) + 0.5) / n
    for j in range(1, dim):
        b = _PRIMES[j - 1]
        for i in range(n):
            pts[i, j] = _radical_inverse(i + 1, b)
    return pts


def latin_hypercube(n: int, dim: int, *, seed: int = 0) -> np.ndarray:
    """LHS (McKay et al. 1979): one sample per row/column stratum."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n, dim), dtype=np.float64)
    for j in range(dim):
        perm = rng.permutation(n)
        pts[:, j] = (perm + rng.random(n)) / n
    return pts


def monte_carlo(n: int, dim: int, *, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random((n, dim))


def morris_trajectories(
    space: ParamSpace, n_trajectories: int, *, seed: int = 0
) -> Tuple[List[ParamSet], List[List[Tuple[int, str]]]]:
    """Morris One-At-A-Time (MOAT) screening design.

    Each trajectory starts at a random grid point and perturbs one parameter
    at a time (a random Δ of grid steps), yielding dim+1 runs per trajectory.
    Returns the flat list of param sets plus, per trajectory, the list of
    (run_index, varied_parameter) pairs needed to compute elementary effects.

    MOAT param sets share a (dim)-long prefix of unchanged values between
    consecutive runs — this is precisely why the paper's reuse tree finds so
    much duplicate computation in MOAT studies.
    """
    rng = np.random.default_rng(seed)
    sets: List[ParamSet] = []
    moves: List[List[Tuple[int, str]]] = []
    for _ in range(n_trajectories):
        idx = {p.name: rng.integers(0, p.cardinality) for p in space.params}
        cur = {p.name: p.values[idx[p.name]] for p in space.params}
        sets.append(paramset(cur))
        order = rng.permutation(space.dim)
        traj: List[Tuple[int, str]] = []
        for k in order:
            p = space.params[k]
            if p.cardinality > 1:
                step = int(rng.integers(1, max(2, p.cardinality // 2)))
                new = (idx[p.name] + step) % p.cardinality
                idx[p.name] = new
                cur[p.name] = p.values[new]
            sets.append(paramset(cur))
            traj.append((len(sets) - 1, p.name))
        moves.append(traj)
    return sets, moves
