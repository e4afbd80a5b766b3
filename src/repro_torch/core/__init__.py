"""Core library: the paper's contribution (multi-level computation reuse for
parameter sensitivity analysis) as composable modules.

Pipeline: sample parameter sets (``params``) → instantiate the hierarchical
workflow (``workflow``) → stage-level dedup + reuse trie (``reuse``) → bucket
merging (``rtma``) → memory-bounded depth-first scheduling + execution
(``rmsr``) → difference metrics (``metrics``) → SA indices (``sa``).

These are composable primitives; the composition point is
``repro_torch.engine.plan_study`` / ``execute_plan`` (DESIGN.md §3) — application
code should call the engine rather than re-wiring these modules.
"""

from repro_torch.core.params import (  # noqa: F401
    Param,
    ParamSpace,
    halton_sequence,
    hammersley_sequence,
    latin_hypercube,
    monte_carlo,
    morris_trajectories,
    paramset,
)
from repro_torch.core.workflow import StageInstance, StageSpec, TaskSpec, Workflow  # noqa: F401
from repro_torch.core.reuse import build_reuse_tree, reuse_stats, stage_level_dedup  # noqa: F401
from repro_torch.core.rtma import Bucket, bucket_reuse_stats, max_bucket_for_budget, rtma_buckets  # noqa: F401
from repro_torch.core.rmsr import (  # noqa: F401
    execute_merged_stage,
    min_active_paths,
    rmsr_schedule,
    simulate_execution,
    tree_peak_bytes,
)
from repro_torch.core.sa import (  # noqa: F401
    MoatResult,
    VbdResult,
    correlation_indices,
    moat_indices,
    saltelli_sample,
    vbd_indices,
)
from repro_torch.core.metrics import (  # noqa: F401
    dice,
    jaccard,
    parallel_efficiency,
    reuse_factor,
    throughput,
)
