"""StudySpec — the serializable description of one study job (DESIGN.md
§18).

A spec is everything a tenant sends over the wire to request a study
against a server's workflow/dataset: which region of the parameter space
to evaluate (explicit points, a grid sweep, or MOAT trajectories over
optional per-parameter bounds), which engine bucketing policy to plan
with, the job's fair-share priority, and an optional wall-clock timeout.
It is a plain-dict payload (``to_json``/``from_json``) so it rides the
length-prefixed frame codec unchanged.

The spec's **signature** is the content address of the work it denotes:
the sha-256 of the canonically-ordered resolved run list plus the
planning knobs that shape task identity. Two tenants submitting specs
with equal signatures produce byte-identical plans and therefore
byte-identical WorkItem keys — the Manager's shared-submission path then
executes the tasks once and fans the completions out to both jobs.
Overlapping-but-unequal specs still reuse partial work through the
server's shared ResultCache (scoped by input and trie prefix, which are
signature-independent).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.params import ParamSet, ParamSpace, paramset
from repro_torch.engine.types import CACHING_POLICIES, POLICIES

__all__ = ["StudySpec", "SpecError"]

# Resolution guardrails: a malformed or adversarial spec must fail at
# admission, not melt the pool.
_MAX_RUNS = 4096


class SpecError(ValueError):
    """The spec cannot be resolved against the server's parameter space
    (unknown parameter, bad sampler, run-count blow-up, …) — rejected at
    admission, before any work is planned or queued."""


@dataclasses.dataclass
class StudySpec:
    """One study request.

    sampler      — "explicit" (``param_sets`` is the run list), "grid"
                   (cartesian sweep of ``names`` over their values, every
                   other parameter pinned at the space default), or "moat"
                   (``n_trajectories`` Morris trajectories, seeded).
    param_sets   — explicit run list (dicts; missing names filled with the
                   space default) for sampler="explicit".
    names        — the parameters a grid sweep varies (default: all).
    bounds       — optional per-parameter value-list overrides (the spec's
                   sub-space): each named parameter must exist in the
                   server space; its listed values replace the server grid
                   for this study only.
    n_trajectories / seed — MOAT sampling shape.
    policy       — engine bucketing policy; caching policies (rtma / rmsr /
                   hybrid) engage the server's shared ResultCache.
    max_bucket_size / active_paths — planner knobs (same as plan_study).
    priority     — within-tenant dispatch priority (higher first).
    timeout_s    — optional wall-clock bound; the server cancels the job
                   when it lapses.
    metrics      — which result payloads to compute: "objective" (the
                   per-run objective vector, averaged over inputs) and/or
                   "per_input" (the per-input objective matrix).
    poll_s       — the client's suggested result-poll interval (carried in
                   the spec so a tenant's tooling round-trips it; the
                   server does not act on it).
    """

    sampler: str = "explicit"
    param_sets: Optional[List[Dict[str, Any]]] = None
    names: Optional[List[str]] = None
    bounds: Optional[Dict[str, List[Any]]] = None
    n_trajectories: int = 2
    seed: int = 0
    policy: str = "hybrid"
    max_bucket_size: Optional[int] = None
    active_paths: Optional[int] = 4
    priority: int = 0
    timeout_s: Optional[float] = None
    metrics: List[str] = dataclasses.field(
        default_factory=lambda: ["objective"]
    )
    poll_s: float = 0.2

    # ------------------------------------------------------------------
    # Wire form
    # ------------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "StudySpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise SpecError(f"unknown StudySpec fields: {sorted(unknown)}")
        return cls(**d)

    # ------------------------------------------------------------------
    # Validation + resolution against a server's space
    # ------------------------------------------------------------------
    def _effective_space(self, space: ParamSpace) -> ParamSpace:
        if not self.bounds:
            return space
        unknown = set(self.bounds) - set(space.names)
        if unknown:
            raise SpecError(
                f"bounds name unknown parameters: {sorted(unknown)}"
            )
        d = {p.name: list(p.values) for p in space.params}
        for name, values in self.bounds.items():
            if not values:
                raise SpecError(f"bounds for {name!r} are empty")
            d[name] = list(values)
        return ParamSpace.from_dict(d)

    def validate(self, space: ParamSpace) -> None:
        if self.sampler not in ("explicit", "grid", "moat"):
            raise SpecError(f"unknown sampler {self.sampler!r}")
        if self.policy not in POLICIES:
            raise SpecError(
                f"unknown policy {self.policy!r} (one of {sorted(POLICIES)})"
            )
        if self.sampler == "explicit" and not self.param_sets:
            raise SpecError("sampler='explicit' needs a non-empty param_sets")
        if self.sampler == "moat" and self.n_trajectories < 1:
            raise SpecError("n_trajectories must be >= 1")
        if self.priority < -16 or self.priority > 16:
            raise SpecError("priority must be within [-16, 16]")
        self._effective_space(space)  # raises on bad bounds

    def resolve(self, space: ParamSpace) -> List[ParamSet]:
        """The concrete run list this spec denotes over ``space``."""
        self.validate(space)
        eff = self._effective_space(space)
        if self.sampler == "explicit":
            out: List[ParamSet] = []
            defaults = dict(eff.default())
            for d in self.param_sets or ():
                unknown = set(d) - set(eff.names)
                if unknown:
                    raise SpecError(
                        f"param_set names unknown parameters: {sorted(unknown)}"
                    )
                full = dict(defaults)
                full.update(d)
                out.append(paramset(full))
        elif self.sampler == "grid":
            names = list(self.names or eff.names)
            unknown = set(names) - set(eff.names)
            if unknown:
                raise SpecError(f"grid names unknown: {sorted(unknown)}")
            by_name = {p.name: p.values for p in eff.params}
            count = 1
            for n in names:
                count *= len(by_name[n])
                if count > _MAX_RUNS:
                    raise SpecError(
                        f"grid sweep exceeds {_MAX_RUNS} runs; shrink "
                        "names/bounds or submit explicit points"
                    )
            defaults = dict(eff.default())
            out = []
            for combo in itertools.product(*(by_name[n] for n in names)):
                full = dict(defaults)
                full.update(zip(names, combo))
                out.append(paramset(full))
        else:  # moat
            from repro_torch.study.samplers import MoatSampler
            from repro_torch.study.state import StudyState

            state = StudyState(eff, seed=self.seed)
            sets, _meta = MoatSampler(self.n_trajectories).propose(state, 0)
            out = list(sets)
        if len(out) > _MAX_RUNS:
            raise SpecError(f"spec resolves to {len(out)} > {_MAX_RUNS} runs")
        if not out:
            raise SpecError("spec resolves to an empty run list")
        return out

    def signature(self, space: ParamSpace) -> str:
        """Content address of the work this spec denotes: equal signatures
        ⇒ identical plans ⇒ identical WorkItem keys ⇒ the Manager executes
        the study once however many tenants submit it. Dispatch-only
        fields (priority, timeout, metrics, poll) are deliberately
        excluded — they change who waits how, not what is computed."""
        runs = self.resolve(space)
        payload = json.dumps(
            {
                "runs": [[list(kv) for kv in ps] for ps in runs],
                "policy": self.policy,
                "max_bucket_size": self.max_bucket_size,
                "active_paths": self.active_paths,
            },
            sort_keys=True,
            default=str,
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def wants_caching(self) -> bool:
        return self.policy in CACHING_POLICIES
