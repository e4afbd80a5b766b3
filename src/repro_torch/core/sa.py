"""Sensitivity-analysis methods (paper §II-A).

* MOAT (Morris One-At-A-Time) screening — elementary effects μ, μ*, σ per
  parameter, from the trajectories produced by
  :func:`repro_torch.core.params.morris_trajectories`.
* VBD (variance-based decomposition / Sobol) — first-order S_i and total S_Ti
  indices via the Saltelli estimator.
* Correlation measures — Pearson and Spearman coefficients between parameter
  values and the output metric.

All methods consume a vector of per-run outputs (here: Dice differences of
each run's segmentation vs the default-parameter segmentation) and return
per-parameter importance indices. Both MOAT and VBD optionally attach
percentile-bootstrap confidence intervals (``n_boot > 0``) — the adaptive
study driver (``repro_torch.study``) prunes on the CI, not the point estimate, so
a noisy-but-possibly-important parameter survives screening.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.params import ParamSet, ParamSpace

__all__ = [
    "MoatResult",
    "moat_indices",
    "VbdResult",
    "saltelli_sample",
    "vbd_indices",
    "pearson",
    "spearman",
    "correlation_indices",
]

CI = Tuple[float, float]


def _percentile_ci(samples: np.ndarray, alpha: float) -> CI:
    lo, hi = np.percentile(samples, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(lo), float(hi)


@dataclasses.dataclass
class MoatResult:
    mu: Dict[str, float]
    mu_star: Dict[str, float]
    sigma: Dict[str, float]
    # percentile-bootstrap CI of mu_star per parameter (None without n_boot)
    mu_star_ci: Optional[Dict[str, CI]] = None

    def ranking(self) -> List[str]:
        return sorted(self.mu_star, key=lambda k: -self.mu_star[k])


def moat_indices(
    space: ParamSpace,
    outputs: Sequence[float],
    moves: Sequence[Sequence[Tuple[int, str]]],
    *,
    n_boot: int = 0,
    seed: int = 0,
    alpha: float = 0.05,
) -> MoatResult:
    """Elementary effects from MOAT trajectories.

    ``moves[t]`` lists (run_index, varied_param) for trajectory t; the
    elementary effect of the k-th move is outputs[i_k] - outputs[i_k - 1].
    With ``n_boot > 0``, each parameter's elementary effects are resampled
    with replacement to attach a percentile CI to μ*.
    """
    effects: Dict[str, List[float]] = {p.name: [] for p in space.params}
    y = np.asarray(outputs, dtype=np.float64)
    for traj in moves:
        for run_idx, pname in traj:
            effects[pname].append(float(y[run_idx] - y[run_idx - 1]))
    mu, mu_star, sigma = {}, {}, {}
    mu_star_ci: Optional[Dict[str, CI]] = {} if n_boot > 0 else None
    rng = np.random.default_rng(seed)
    for name, es in effects.items():
        arr = np.asarray(es) if es else np.zeros(1)
        mu[name] = float(arr.mean())
        mu_star[name] = float(np.abs(arr).mean())
        sigma[name] = float(arr.std())
        if mu_star_ci is not None:
            draws = rng.integers(0, len(arr), size=(n_boot, len(arr)))
            mu_star_ci[name] = _percentile_ci(
                np.abs(arr[draws]).mean(axis=1), alpha
            )
    return MoatResult(mu=mu, mu_star=mu_star, sigma=sigma, mu_star_ci=mu_star_ci)


@dataclasses.dataclass
class VbdResult:
    first_order: Dict[str, float]
    total: Dict[str, float]
    # percentile-bootstrap CIs per parameter (None without n_boot)
    first_order_ci: Optional[Dict[str, CI]] = None
    total_ci: Optional[Dict[str, CI]] = None

    def ranking(self) -> List[str]:
        return sorted(self.total, key=lambda k: -self.total[k])


def saltelli_sample(
    space: ParamSpace, n_base: int, *, seed: int = 0
) -> Tuple[List[ParamSet], int]:
    """Saltelli cross-sampling: A, B and the d A_B^(i) matrices.

    Returns (param_sets, n_base); len(param_sets) == n_base * (dim + 2).
    Run order: [A rows, B rows, A_B^(0) rows, ..., A_B^(d-1) rows].
    """
    rng = np.random.default_rng(seed)
    d = space.dim
    A = rng.random((n_base, d))
    B = rng.random((n_base, d))
    blocks = [A, B]
    for i in range(d):
        AB = A.copy()
        AB[:, i] = B[:, i]
        blocks.append(AB)
    pts = np.concatenate(blocks, axis=0)
    return space.quantise(pts), n_base


def vbd_indices(
    space: ParamSpace,
    outputs: Sequence[float],
    n_base: int,
    *,
    n_boot: int = 0,
    seed: int = 0,
    alpha: float = 0.05,
) -> VbdResult:
    """Sobol indices with the Jansen estimators.

    With ``n_boot > 0``, the ``n_base`` design rows are resampled with
    replacement (keeping each row's A/B/A_B^(i) runs together, so resampled
    estimates stay internally consistent) to attach percentile CIs.
    """
    y = np.asarray(outputs, dtype=np.float64)
    d = space.dim
    if len(y) != n_base * (d + 2):
        raise ValueError("outputs length does not match a Saltelli design")
    yA = y[:n_base]
    yB = y[n_base : 2 * n_base]
    yABs = [y[(2 + i) * n_base : (3 + i) * n_base] for i in range(d)]

    def estimate(rows: np.ndarray) -> Tuple[List[float], List[float]]:
        a, b = yA[rows], yB[rows]
        var = np.var(np.concatenate([a, b])) or 1e-12
        first = [float(np.mean(b * (ab[rows] - a)) / var) for ab in yABs]
        total = [float(0.5 * np.mean((a - ab[rows]) ** 2) / var) for ab in yABs]
        return first, total

    all_rows = np.arange(n_base)
    first, total = estimate(all_rows)
    first_ci = total_ci = None
    if n_boot > 0:
        rng = np.random.default_rng(seed)
        boot_first = np.empty((n_boot, d))
        boot_total = np.empty((n_boot, d))
        for k in range(n_boot):
            boot_first[k], boot_total[k] = estimate(
                rng.integers(0, n_base, size=n_base)
            )
        first_ci = {
            p.name: _percentile_ci(boot_first[:, i], alpha)
            for i, p in enumerate(space.params)
        }
        total_ci = {
            p.name: _percentile_ci(boot_total[:, i], alpha)
            for i, p in enumerate(space.params)
        }
    return VbdResult(
        first_order={p.name: first[i] for i, p in enumerate(space.params)},
        total={p.name: total[i] for i, p in enumerate(space.params)},
        first_order_ci=first_ci,
        total_ci=total_ci,
    )


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xc, yc = x - x.mean(), y - y.mean()
    denom = np.sqrt((xc**2).sum() * (yc**2).sum())
    return float((xc * yc).sum() / denom) if denom > 0 else 0.0


def spearman(x: np.ndarray, y: np.ndarray) -> float:
    rx = np.argsort(np.argsort(x)).astype(np.float64)
    ry = np.argsort(np.argsort(y)).astype(np.float64)
    return pearson(rx, ry)


def correlation_indices(
    space: ParamSpace, param_sets: Sequence[ParamSet], outputs: Sequence[float]
) -> Dict[str, Dict[str, float]]:
    y = np.asarray(outputs, dtype=np.float64)
    out: Dict[str, Dict[str, float]] = {}
    for p in space.params:
        vals = []
        for ps in param_sets:
            v = dict(ps)[p.name]
            vals.append(float(p.values.index(v)) if not isinstance(v, (int, float)) else float(v))
        x = np.asarray(vals)
        out[p.name] = {"pearson": pearson(x, y), "spearman": spearman(x, y)}
    return out
