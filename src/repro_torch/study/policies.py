"""Policies — the "decide" half of the adaptive study round loop.

Contract (DESIGN.md §11): a policy is an object with

    decide(state, record) -> Decision

inspecting the round's analysis (indices + bootstrap CIs) and the study
history, and returning what happens next: which parameters to prune
(``Decision.prune``), which phase runs next (``"moat"`` | ``"vbd"`` |
``"refine"`` | ``"stop"``), and why. The driver applies the decision —
policies never mutate state, which keeps them unit-testable on synthetic
records.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.study.state import RoundRecord, StudyState

__all__ = ["Decision", "ScreenThenRefinePolicy"]


@dataclasses.dataclass
class Decision:
    prune: List[str]
    next_phase: str  # "moat" | "vbd" | "refine" | "stop"
    reason: str
    converged: bool = False

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class ScreenThenRefinePolicy:
    """The canonical adaptive workflow (Teodoro et al. 1612.03413; Barreiros
    & Teodoro 1811.11653): MOAT screening prunes unimportant parameters,
    VBD quantifies the survivors, then grid refinement densifies around the
    important region until improvements dry up.

    Pruning is CI-aware: a parameter is pruned after MOAT only when the
    *upper* end of its bootstrapped μ* interval falls below
    ``mu_star_rel`` × the best μ* point estimate — i.e. when even an
    optimistic read says it does not matter. After VBD the same rule runs
    on S_Ti with ``total_rel``. Without CIs (``n_boot=0``) the point
    estimates are compared directly. At least ``min_active`` parameters
    always survive (the top of the ranking is exempt from pruning).

    Refinement stops — and the study converges — when a refinement round
    improves the incumbent objective by less than ``improve_tol``
    (relative), or after ``max_refine_rounds`` refinements.
    """

    def __init__(
        self,
        *,
        mu_star_rel: float = 0.1,
        total_rel: float = 0.05,
        min_active: int = 2,
        max_refine_rounds: int = 1,
        improve_tol: float = 1e-3,
    ):
        self.mu_star_rel = mu_star_rel
        self.total_rel = total_rel
        self.min_active = min_active
        self.max_refine_rounds = max_refine_rounds
        self.improve_tol = improve_tol

    def _prunable(
        self,
        point: Dict[str, float],
        upper: Dict[str, float],
        rel_threshold: float,
        keep: int,
    ) -> List[str]:
        """Names whose optimistic (CI-upper) index stays below the relative
        threshold, never pruning into the top-``keep`` of the ranking."""
        if not point:
            return []
        ranking = sorted(point, key=lambda k: -point[k])
        protected = set(ranking[: max(0, keep)])
        cutoff = rel_threshold * max(max(point.values()), 1e-12)
        return [
            name
            for name in ranking
            if name not in protected and upper.get(name, point[name]) < cutoff
        ]

    def decide(self, state: StudyState, record: RoundRecord) -> Decision:
        analysis = record.analysis
        if record.kind == "moat":
            point = analysis.get("mu_star", {})
            # analysis stores ci=None when n_boot=0: fall back to points
            upper = {
                k: hi for k, (_, hi) in (analysis.get("mu_star_ci") or {}).items()
            }
            prune = self._prunable(point, upper, self.mu_star_rel, self.min_active)
            if len(prune) >= len(state.active):
                # never prune to zero: spare the top-ranked name (prunable
                # names come back most-important-first)
                prune = prune[1:]
            return Decision(
                prune=prune,
                next_phase="vbd",
                reason=(
                    f"MOAT screen: pruned {len(prune)}/{len(state.active)} "
                    f"params below {self.mu_star_rel:.0%} of max mu*"
                ),
            )
        if record.kind == "vbd":
            point = analysis.get("total", {})
            upper = {
                k: hi for k, (_, hi) in (analysis.get("total_ci") or {}).items()
            }
            prune = self._prunable(point, upper, self.total_rel, self.min_active)
            return Decision(
                prune=prune,
                next_phase="refine",
                reason=(
                    f"VBD: pruned {len(prune)} params below "
                    f"{self.total_rel:.0%} of max S_Ti; refining around best"
                ),
            )
        if record.kind in ("refine", "tune"):
            n_refines = sum(1 for r in state.rounds if r.kind == record.kind)
            improved = record.analysis.get("improved", 0.0)
            scale = abs(state.best[1]) if state.best else 1.0
            if improved <= self.improve_tol * max(scale, 1e-12):
                return Decision(
                    prune=[],
                    next_phase="stop",
                    reason=f"converged: refinement improved {improved:.2e}",
                    converged=True,
                )
            if n_refines >= self.max_refine_rounds:
                return Decision(
                    prune=[],
                    next_phase="stop",
                    reason=f"refine budget exhausted ({n_refines} rounds)",
                    converged=False,
                )
            return Decision(
                prune=[], next_phase="refine", reason="refinement still improving"
            )
        return Decision(prune=[], next_phase="stop", reason=f"unknown round kind {record.kind!r}")
