"""Adaptive multi-round SA driver — the science loop above the engine
(DESIGN.md §11).

``StudyDriver`` runs rounds of propose → evaluate → analyze → decide over a
round-persistent ``StudyState``: a pluggable sampler proposes ParamSets,
the engine executes only the round's *delta* (incremental planning against
the cached trie, one persistent Manager session, a store-backed result
cache that survives eviction and process restarts), ``core.sa`` computes
indices with bootstrap CIs, and a pluggable policy prunes / refines /
stops. The canonical workflow is MOAT screening → VBD on the survivors →
grid refinement, plus a coordinate-descent ``tune`` mode.

``run_fleet_study`` scales the same loop across worker *processes*: each
round's delta is sharded over a spawn pool whose members all mount one
crash-safe :class:`~repro_torch.runtime.SharedStore` directory, and the leader
plans round N+1 against the union of every process's committed keys
(DESIGN.md §12) — bit-identical indices, pooled reuse.
In this package it is a copy that no test or card run drives yet: its
spawn worker processes come with slice 3 of the port (the multi-process
runtime), where each worker opens its own CUDA context.
"""

from repro_torch.study.driver import StudyDriver, run_fleet_study  # noqa: F401
from repro_torch.study.policies import Decision, ScreenThenRefinePolicy  # noqa: F401
from repro_torch.study.samplers import (  # noqa: F401
    MoatSampler,
    RefinementSampler,
    SaltelliSampler,
    active_space,
    complete,
)
from repro_torch.study.state import RoundRecord, StudyState  # noqa: F401
