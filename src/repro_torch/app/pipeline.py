"""The paper's motivating application as a :class:`repro_torch.core.Workflow`.

Three coarse stages (Fig 1): **normalization** (parameter-free, hence fully
shared across SA runs), **segmentation** (seven fine-grain tasks Seg0..Seg6,
consuming the Table I parameters in pipeline order) and **comparison** (Dice
vs the default-parameter reference).

The per-task parameter mapping is the contract the reuse trie keys on:

  Seg0 background   (B, G, R)          Seg4 area-pre     (minS, maxS)
  Seg1 rbc          (T1, T2)           Seg5 watershed    (minSPL, WConn)
  Seg2 morph-recon  (G1, RC)           Seg6 area-final   (minSS, maxSS)
  Seg3 threshold+fh (G2, FH)

Task state is a dict of tensors on the study's device. Scalar parameters
enter the operators as Python numbers; a float32 tensor compared with or
combined with one computes in float32.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.app import ops
from repro_torch.core import ParamSpace, StageSpec, TaskSpec, Workflow, dice
from repro_torch.core.metrics import reuse_factor
from repro_torch.core.params import ParamSet
from repro_torch.device import resolve_device
from repro_torch.engine import ClusterSpec, MemoryBudget, execute_plan, plan_study

__all__ = [
    "TABLE1_SPACE",
    "synthetic_tile",
    "build_segmentation_stage",
    "build_workflow",
    "run_study",
    "resolve_device",
    "state_from_numpy",
    "state_to_numpy",
]

# --------------------------------------------------------------------------
# Table I of the paper — the application parameter space.
# --------------------------------------------------------------------------

TABLE1_SPACE = ParamSpace.from_dict(
    {
        "B": list(range(210, 241, 10)),
        "G": list(range(210, 241, 10)),
        "R": list(range(210, 241, 10)),
        "T1": [x / 2.0 for x in range(5, 16)],  # 2.5 .. 7.5
        "T2": [x / 2.0 for x in range(5, 16)],
        "G1": list(range(5, 81, 5)),
        "G2": list(range(2, 41, 2)),
        "minS": list(range(2, 41, 2)),
        "maxS": list(range(900, 1501, 50)),
        "minSPL": list(range(5, 81, 5)),
        "minSS": list(range(2, 41, 2)),
        "maxSS": list(range(900, 1501, 50)),
        "FH": [4, 8],
        "RC": [4, 8],
        "WConn": [4, 8],
    }
)


def synthetic_tile(h: int = 256, w: int = 256, *, seed: int = 0) -> np.ndarray:
    """Synthetic H&E-like tile: pink stroma, dark nuclei blobs, red RBCs and
    a bright glass/background band — enough structure for every Table I
    parameter to matter. Numpy, bit-identical to the JAX package's tile."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 215 + rng.normal(0, 6, (h, w))  # R
    img[..., 1] = 170 + rng.normal(0, 6, (h, w))  # G
    img[..., 2] = 195 + rng.normal(0, 6, (h, w))  # B
    yy, xx = np.mgrid[0:h, 0:w]

    def blobs(n, rmin, rmax, color, jitter=10.0):
        for _ in range(n):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            rad = rng.uniform(rmin, rmax)
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            m = d2 < rad**2
            for c in range(3):
                img[..., c][m] = color[c] + rng.normal(0, jitter)

    blobs(max(4, h * w // 1600), 3.0, 9.0, (110, 70, 150))  # nuclei (purple)
    blobs(max(2, h * w // 6400), 2.0, 6.0, (190, 60, 70))  # RBCs (red)
    img[: h // 8, :, :] = 245 + rng.normal(0, 3, (h // 8, w, 3))  # glass
    return np.clip(img, 0, 255).astype(np.float32)


# --------------------------------------------------------------------------
# Task implementations. State is a dict of tensors flowing down the pipeline.
# --------------------------------------------------------------------------


def _t_background(state, B, G, R):
    rgb = state["rgb"]
    fg = ops.background_mask(rgb, float(B), float(G), float(R))
    return {"rgb": rgb, "fg": fg}


def _t_rbc(state, T1, T2):
    rgb, fg = state["rgb"], state["fg"]
    rbc = ops.rbc_mask(rgb, float(T1), float(T2))
    keep = fg & ~rbc
    gray = (255.0 - rgb[..., 2]) * keep.to(torch.float32)  # hematoxylin proxy
    return {"gray": gray}


def _t_recon(state, G1, RC):
    gray = state["gray"]
    marker = torch.clamp_min(gray - float(G1), 0.0)
    recon = ops.morph_reconstruct(marker, gray, conn=int(RC))
    return {"gray": gray, "residual": gray - recon}


def _t_threshold(state, G2, FH):
    cand = state["residual"] > float(G2) * 0.5
    return {"mask": ops.fill_holes(cand, conn=int(FH))}


def _t_area_pre(state, minS, maxS):
    return {"mask": ops.area_filter(state["mask"], int(minS), int(maxS))}


def _t_watershed(state, minSPL, WConn):
    return {"mask": ops.watershed_split(state["mask"], int(minSPL), conn=int(WConn))}


def _t_area_final(state, minSS, maxSS):
    return {"mask": ops.area_filter(state["mask"], int(minSS), int(maxSS))}


def build_segmentation_stage(
    h: int, w: int, costs: Optional[Dict[str, float]] = None
) -> StageSpec:
    """The Seg0..Seg6 pipeline with byte-exact output sizes for the memory
    model (float32 image payloads dominate; masks are byte-packed)."""
    px = h * w
    costs = costs or {}
    spec = [
        ("seg0_background", ("B", "G", "R"), _t_background, 4 * px * 3 + px),
        ("seg1_rbc", ("T1", "T2"), _t_rbc, 4 * px),
        ("seg2_recon", ("G1", "RC"), _t_recon, 8 * px),
        ("seg3_threshold", ("G2", "FH"), _t_threshold, px),
        ("seg4_area_pre", ("minS", "maxS"), _t_area_pre, px),
        ("seg5_watershed", ("minSPL", "WConn"), _t_watershed, px),
        ("seg6_area_final", ("minSS", "maxSS"), _t_area_final, px),
    ]
    default_cost = {"seg2_recon": 4.0, "seg5_watershed": 3.0}
    tasks = tuple(
        TaskSpec(
            name=n,
            param_names=p,
            fn=f,
            cost=costs.get(n, default_cost.get(n, 1.0)),
            output_bytes=b,
        )
        for n, p, f, b in spec
    )
    return StageSpec(name="segmentation", tasks=tasks)


def _t_normalize(state):
    return {"rgb": ops.normalize_tile(state["raw"])}


def build_workflow(h: int, w: int, costs: Optional[Dict[str, float]] = None) -> Workflow:
    px = h * w
    norm = StageSpec(
        name="normalization",
        tasks=(
            TaskSpec(
                name="normalize",
                param_names=(),
                fn=_t_normalize,
                cost=1.0,
                output_bytes=12 * px,
            ),
        ),
    )
    seg = build_segmentation_stage(h, w, costs)
    return Workflow(stages=(norm, seg))


# --------------------------------------------------------------------------
# Tensor boundary and device.
# --------------------------------------------------------------------------


def state_from_numpy(
    state: Mapping[str, np.ndarray], device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """``{name: ndarray}`` (for example a JAX task state through
    ``np.asarray``) to ``{name: Tensor}`` on ``device``, dtypes kept."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in state.items()}


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{name: Tensor}`` to host ``{name: ndarray}``, dtypes kept."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


# --------------------------------------------------------------------------
# SA study entry point: a thin caller of the StudyPlanner engine.
# --------------------------------------------------------------------------


def run_study(
    image: np.ndarray,
    param_sets: Sequence[ParamSet],
    *,
    strategy: str = "rmsr",
    max_bucket_size: Optional[int] = None,
    active_paths: Optional[int] = None,
    reference_params: Optional[ParamSet] = None,
    costs: Optional[Dict[str, float]] = None,
    n_workers: int = 1,
    memory_budget_bytes: Optional[int] = None,
    backend: Any = None,
    hierarchy: Any = None,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Execute an SA study over one tile and return per-run Dice + counters.

    ``strategy`` is the engine's bucketing policy ∈ {"none", "stage",
    "rtma", "rmsr", "hybrid"}; ``max_bucket_size`` bounds RTMA/hybrid
    merging (default rtma→8; rmsr merges maximally, the paper's headline
    configuration). ``n_workers`` dispatches buckets demand-driven through
    the Manager. ``backend`` is the session's WorkerBackend: ``None`` or
    ``"thread"`` for in-process Worker threads, or a constructed backend.

    ``device`` is where the tile goes, once, and where every task state
    lives: ``None`` means ``cuda:0`` and raises without CUDA
    (:func:`resolve_device`).

    ``tasks_executed`` is the MEASURED count (cache hits subtracted), while
    ``planned_tasks_executed`` / ``reuse_fraction`` report the plan's
    merge-level accounting (the paper's analytic counts).
    """
    dev = resolve_device(device)
    h, w = image.shape[:2]
    ref_params = reference_params or TABLE1_SPACE.default()

    t0 = time.perf_counter()
    wf = build_workflow(h, w, costs)
    if active_paths is None and memory_budget_bytes is None:
        active_paths = 4  # headline depth-first width when nothing to solve
    plan = plan_study(
        wf,
        list(param_sets),
        memory=MemoryBudget(bytes=memory_budget_bytes),
        cluster=ClusterSpec(n_workers=n_workers),
        policy=strategy,
        max_bucket_size=max_bucket_size,
        active_paths=active_paths,
    )
    raw = {"raw": torch.from_numpy(np.asarray(image)).to(dev)}
    result = execute_plan(plan, raw, backend=backend, hierarchy=hierarchy)

    ref_plan = plan_study(wf, [ref_params], policy="rmsr", active_paths=1)
    ref_mask = execute_plan(ref_plan, raw).outputs[0]["mask"]

    dices = [
        float(dice(result.outputs[rid]["mask"], ref_mask))
        for rid in range(len(param_sets))
    ]
    wall = time.perf_counter() - t0
    return {
        "dice": dices,
        "tasks_total": plan.tasks_total,
        "tasks_executed": result.tasks_executed,
        "planned_tasks_executed": plan.tasks_executed,
        "reuse_fraction": plan.reuse_fraction,
        "reuse_factor": reuse_factor(result.tasks_executed, plan.tasks_total),
        "peak_bytes": plan.peak_bytes,
        "wall_seconds": wall,
        "reference_mask": ref_mask.cpu().numpy(),
        "cache_hits": result.cache_hits,
        "cache_misses": result.cache_misses,
        "cache_spills": result.cache_spills,
        "backend": result.backend,
        "dispatch_counts": dict(result.dispatch_counts),
        "cache_flushed": 0,  # no persistent spill store in one-shot mode
        "plan": plan,
    }
