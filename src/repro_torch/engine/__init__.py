"""Unified StudyPlanner engine: one plan→bucket→schedule→dispatch pipeline
for every SA workload (DESIGN.md §3/§4).

``plan_study`` composes the paper's contributions — stage-level dedup, reuse
trees (RTMA merging), memory-bounded AOT schedules (RMSR) — behind one
pluggable bucketing policy; ``execute_study`` streams a whole dataset of
inputs through one plan inside a single persistent Manager session with
per-input stage edges and input-scoped result caching (DESIGN.md §10); and
``execute_plan`` is its one-input special case. The pathology app, the
SA-over-serving workload, the examples and every benchmark are thin callers
of these functions.
"""

from repro_torch.engine.types import (  # noqa: F401
    BucketPlan,
    ClusterSpec,
    MemoryBudget,
    StagePlan,
    StudyPlan,
    StudyResult,
    StudyStreamResult,
)
from repro_torch.engine.planner import TrieLedger, plan_study  # noqa: F401
from repro_torch.engine.executor import ResultCache, execute_bucket, execute_plan  # noqa: F401
from repro_torch.engine.streaming import execute_study  # noqa: F401
