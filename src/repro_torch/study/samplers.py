"""Samplers — the "propose" half of the adaptive study round loop.

Contract (DESIGN.md §11): a sampler is an object with a ``name`` and

    propose(state, round_index) -> (param_sets, meta)

where ``param_sets`` is the round's full proposed run-list over the *whole*
parameter space (pruned parameters completed with their frozen values, so
cross-round trie prefixes stay shareable) and ``meta`` carries whatever the
analyzer needs to turn the objective vector back into indices (MOAT's
``moves``, Saltelli's ``n_base``). Samplers must be deterministic functions
of ``(state.seed, round_index, state.active)`` — the driver's
reproducibility and the tests' one-shot oracle both rely on it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.core.params import (
    ParamSet,
    ParamSpace,
    morris_trajectories,
    paramset,
)
from repro_torch.core.sa import saltelli_sample
from repro_torch.study.state import StudyState

__all__ = [
    "active_space",
    "complete",
    "MoatSampler",
    "SaltelliSampler",
    "RefinementSampler",
]


def active_space(state: StudyState) -> ParamSpace:
    """The sub-space of still-active parameters, in original order."""
    return ParamSpace(
        tuple(p for p in state.space.params if p.name in state.active)
    )


def complete(sub: ParamSet, state: StudyState) -> ParamSet:
    """Extend an active-subspace ParamSet with the frozen values of every
    pruned parameter (canonical sorted-tuple form)."""
    d = dict(sub)
    d.update(state.frozen)
    return paramset(d)


class MoatSampler:
    """Morris One-At-A-Time trajectories over the active sub-space (the
    screening phase). ``meta['moves']`` indexes into the proposed list."""

    name = "moat"

    def __init__(self, n_trajectories: int = 2):
        self.n_trajectories = n_trajectories

    def propose(
        self, state: StudyState, round_index: int
    ) -> Tuple[List[ParamSet], Dict[str, Any]]:
        sub = active_space(state)
        sets, moves = morris_trajectories(
            sub, self.n_trajectories, seed=state.seed + round_index
        )
        return [complete(s, state) for s in sets], {
            "method": "moat",
            "moves": [[[int(i), p] for i, p in traj] for traj in moves],
        }


class SaltelliSampler:
    """Saltelli A/B/A_B^(i) cross-sampling over the active sub-space (the
    VBD phase on screening survivors)."""

    name = "vbd"

    def __init__(self, n_base: int = 8):
        self.n_base = n_base

    def propose(
        self, state: StudyState, round_index: int
    ) -> Tuple[List[ParamSet], Dict[str, Any]]:
        sub = active_space(state)
        sets, n_base = saltelli_sample(
            sub, self.n_base, seed=state.seed + round_index
        )
        return [complete(s, state) for s in sets], {
            "method": "vbd",
            "n_base": n_base,
        }


class RefinementSampler:
    """Grid densification around the incumbent best point: one-at-a-time
    sweeps of each active parameter over its grid neighbourhood (±``radius``
    steps), every other parameter held at the incumbent value.

    Because each proposal differs from the (already-evaluated) incumbent in
    exactly one coordinate, proposals share the incumbent's trie prefix up
    to that coordinate's task — the refinement phase is where cross-round
    incremental reuse pays the most.
    """

    name = "refine"

    def __init__(self, radius: int = 1):
        self.radius = radius

    def propose(
        self, state: StudyState, round_index: int
    ) -> Tuple[List[ParamSet], Dict[str, Any]]:
        anchor = dict(state.best[0]) if state.best else dict(state.space.default())
        sets: List[ParamSet] = [paramset(anchor)]
        for p in state.space.params:
            if p.name not in state.active:
                continue
            cur = p.values.index(anchor[p.name])
            for step in range(-self.radius, self.radius + 1):
                idx = cur + step
                if step == 0 or idx < 0 or idx >= p.cardinality:
                    continue
                d = dict(anchor)
                d[p.name] = p.values[idx]
                sets.append(paramset(d))
        return sets, {"method": "refine", "anchor": [[k, v] for k, v in sorted(anchor.items())]}
