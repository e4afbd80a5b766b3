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

import functools
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.app import ops
from repro_torch.core import ParamSpace, StageSpec, TaskSpec, Workflow, dice
from repro_torch.core.metrics import reuse_factor
from repro_torch.core.params import ParamSet
from repro_torch.device import resolve_device
from repro_torch.engine import (
    ClusterSpec,
    MemoryBudget,
    execute_plan,
    execute_study,
    plan_study,
)

__all__ = [
    "TABLE1_SPACE",
    "synthetic_tile",
    "build_segmentation_stage",
    "build_workflow",
    "run_study",
    "run_dataset_study",
    "run_adaptive_study",
    "run_fleet_study",
    "pathology_rpc_build",
    "pathology_fleet_build",
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
    parameter to matter. Numpy, bit-identical to the JAX package's tile.
    Each blob is drawn inside its bounding box, the same pixels as a test
    over the whole tile, so a 4096² tile takes seconds, not an hour."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 215 + rng.normal(0, 6, (h, w))  # R
    img[..., 1] = 170 + rng.normal(0, 6, (h, w))  # G
    img[..., 2] = 195 + rng.normal(0, 6, (h, w))  # B

    def blobs(n, rmin, rmax, color, jitter=10.0):
        for _ in range(n):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            rad = rng.uniform(rmin, rmax)
            r = int(np.ceil(rad))
            y0, x0 = max(0, cy - r), max(0, cx - r)
            yy, xx = np.ogrid[y0:min(h, cy + r + 1), x0:min(w, cx + r + 1)]
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < rad**2
            box = img[y0:y0 + m.shape[0], x0:x0 + m.shape[1]]
            for c in range(3):
                box[..., c][m] = color[c] + rng.normal(0, jitter)

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
# SA study drivers: thin callers of the StudyPlanner engine.
# --------------------------------------------------------------------------


def _worker_stats(dev: torch.device) -> Dict[str, int]:
    """What a worker process built by :func:`pathology_rpc_build` or
    :func:`pathology_fleet_build` reports of its device beside its counters
    (the backends and the fleet runner sum it over the workers): 1 if it
    works on the card, 1 if it holds a CUDA context, its ``morph_recon``
    kernel launches, 1 if it made any, and its peak device memory."""
    from repro_torch.kernels import morph_recon

    launches = morph_recon.LAUNCHES.value
    on_card = dev.type == "cuda"
    return {
        "on_cuda": int(on_card),
        "cuda_context": int(torch.cuda.is_initialized()),
        "morph_recon_launches": launches,
        "launched_morph_recon": int(launches > 0),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if on_card else 0,
    }


def pathology_rpc_build(
    images: Sequence[np.ndarray],
    costs: Optional[Dict[str, float]] = None,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Spawn-picklable ``build`` for the RPC process and socket backends
    (:class:`repro_torch.runtime.ProcessRpcBackend`,
    :class:`repro_torch.runtime.SocketBackend`): each worker process calls
    this once to construct its own workflow and input states from the tile
    arrays shipped in the build kwargs — inputs ride the spawn boundary
    once, at worker start; results only ever come back as SharedStore keys.
    ``device`` is resolved in the worker: ``None`` means its card, and
    raises there without CUDA. ``"stats"`` is :func:`_worker_stats`, which
    the worker ships with its heartbeats.
    """
    dev = resolve_device(device)
    images = [np.asarray(im) for im in images]
    h, w = images[0].shape[:2]
    return {
        "workflow": build_workflow(h, w, costs),
        "inputs": [{"raw": torch.as_tensor(im, device=dev)} for im in images],
        "stats": functools.partial(_worker_stats, dev),
    }


def _backend_for(
    backend: Any,
    images: Sequence[np.ndarray],
    costs: Optional[Dict[str, float]],
    store_dir: Optional[str] = None,
    device: Union[None, str, torch.device] = None,
) -> Any:
    """Resolve the app-level ``backend`` spec: ``None``/``"thread"`` pass
    through to the Manager's default; ``"process"`` — optionally with the
    per-optimization flag suffix of DESIGN.md §14, e.g.
    ``"process[-async]"`` or ``"process[none,batch,max_batch=4]"`` (see
    :func:`repro_torch.runtime.transport.process_flag_kwargs`) — builds a
    ProcessRpcBackend whose workers reconstruct this exact study via
    :func:`pathology_rpc_build`; a constructed WorkerBackend passes
    through untouched. ``store_dir`` mounts the workers' stores on a
    caller-owned directory (the adaptive study's persistent pool, so a
    resumed study still rehydrates the workers' task outputs); without it
    the backend owns a throwaway tempdir the caller must ``cleanup()``.
    ``device`` is the caller's, passed to the workers' builds as given."""
    build_kwargs = {
        "images": [np.asarray(im) for im in images],
        "costs": costs,
        "device": device,
    }
    if isinstance(backend, str) and backend.startswith("process"):
        from repro_torch.runtime import ProcessRpcBackend
        from repro_torch.runtime.transport import process_flag_kwargs

        return ProcessRpcBackend(
            build=pathology_rpc_build,
            build_kwargs=build_kwargs,
            store_dir=store_dir,
            **process_flag_kwargs(backend),
        )
    if isinstance(backend, str) and backend.startswith("socket"):
        # "socket[...]" (DESIGN.md §16): TCP control plane; workers rebuild
        # this study from the same spawn-picklable build. A store= token in
        # the spec (e.g. store=obj:<root>) overrides store_dir so a fleet
        # can run with no shared filesystem at all.
        from repro_torch.runtime import SocketBackend, socket_flag_kwargs

        kwargs = socket_flag_kwargs(backend)
        kwargs.setdefault("store", store_dir)
        return SocketBackend(build=pathology_rpc_build, build_kwargs=build_kwargs, **kwargs)
    return backend


def _backend_cleanup(spec: Any, backend_obj: Any) -> None:
    """Release a backend `_backend_for` constructed (drop a throwaway
    tempdir store); caller-provided backends are untouched."""
    if (
        isinstance(spec, str)
        and (spec.startswith("process") or spec.startswith("socket"))
        and hasattr(backend_obj, "cleanup")
    ):
        backend_obj.cleanup()


def _round_detail(r: Any) -> Dict[str, Any]:
    """One round's reporting dict, shared by the adaptive and fleet study
    summaries so the two never drift."""
    return {
        "kind": r.kind,
        "n_proposed": r.n_proposed,
        "n_new": r.n_new,
        "planned_tasks": r.planned_tasks,
        "planned_known": r.planned_known,
        "tasks_executed": r.tasks_executed,
        "cache_hits": r.cache_hits,
        "analysis": r.analysis,
        "decision": r.decision,
    }


def _plan_image_study(
    h: int,
    w: int,
    param_sets: Sequence[ParamSet],
    *,
    strategy: str,
    max_bucket_size: Optional[int],
    active_paths: Optional[int],
    costs: Optional[Dict[str, float]],
    n_workers: int,
    memory_budget_bytes: Optional[int],
):
    """Shared planning preamble of the single-tile and dataset drivers:
    build the workflow for the tile shape and plan the study (with the
    headline ``active_paths=4`` default when there is no budget to solve
    against). Returns ``(workflow, plan, cluster)``."""
    wf = build_workflow(h, w, costs)
    memory = MemoryBudget(bytes=memory_budget_bytes)
    cluster = ClusterSpec(n_workers=n_workers)
    if active_paths is None and memory_budget_bytes is None:
        active_paths = 4  # headline depth-first width when nothing to solve
    plan = plan_study(
        wf,
        list(param_sets),
        memory=memory,
        cluster=cluster,
        policy=strategy,
        max_bucket_size=max_bucket_size,
        active_paths=active_paths,
    )
    return wf, plan, cluster


def _tile_inputs(
    images: Sequence[np.ndarray], dev: torch.device, caller: str
) -> Tuple[int, int, List[Dict[str, torch.Tensor]]]:
    """Check that the tiles share one shape and move each to ``dev``, once:
    ``(h, w, [{"raw": tensor}, ...])``."""
    if not images:
        raise ValueError(f"{caller} needs at least one tile")
    h, w = images[0].shape[:2]
    if any(im.shape[:2] != (h, w) for im in images):
        raise ValueError("all tiles must share one (h, w) shape")
    return h, w, [{"raw": torch.from_numpy(np.asarray(im)).to(dev)} for im in images]


def _reference_masks(
    wf: Workflow, ref_params: ParamSet, raws: Sequence[Any], cluster: ClusterSpec
) -> List[torch.Tensor]:
    """The default-parameter segmentation of every tile, left on the tiles'
    device."""
    ref_plan = plan_study(wf, [ref_params], policy="rmsr", active_paths=1)
    ref_stream = execute_study(ref_plan, raws, cluster=cluster)
    return [ref_stream.outputs[i][0]["mask"] for i in range(len(raws))]


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
    the Manager. ``backend`` picks the session's WorkerBackend — ``None``
    or ``"thread"`` for in-process Worker threads, ``"process…"`` for RPC
    worker processes or ``"socket…"`` for socket workers pooling results
    through a SharedStore (:func:`_backend_for`; the reference segmentation
    stays in-process: it is a single run), or a constructed backend.

    ``device`` is where the tile goes, once, and where every task state
    lives: ``None`` means ``cuda:0`` and raises without CUDA
    (:func:`resolve_device`). Worker processes resolve it in their own
    builds.

    ``tasks_executed`` is the MEASURED count (cache hits subtracted) —
    the same semantics as ``run_dataset_study`` — while
    ``planned_tasks_executed`` / ``reuse_fraction`` report the plan's
    merge-level accounting (the paper's analytic counts).
    """
    dev = resolve_device(device)
    h, w = image.shape[:2]
    ref_params = reference_params or TABLE1_SPACE.default()

    t0 = time.perf_counter()
    wf, plan, _cluster = _plan_image_study(
        h, w, param_sets,
        strategy=strategy, max_bucket_size=max_bucket_size,
        active_paths=active_paths, costs=costs, n_workers=n_workers,
        memory_budget_bytes=memory_budget_bytes,
    )
    raw = {"raw": torch.from_numpy(np.asarray(image)).to(dev)}
    backend_obj = _backend_for(backend, [image], costs, device=device)
    try:
        result = execute_plan(plan, raw, backend=backend_obj, hierarchy=hierarchy)
    finally:
        _backend_cleanup(backend, backend_obj)

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


def run_dataset_study(
    images: Sequence[np.ndarray],
    param_sets: Sequence[ParamSet],
    *,
    strategy: str = "hybrid",
    max_bucket_size: Optional[int] = None,
    active_paths: Optional[int] = None,
    reference_params: Optional[ParamSet] = None,
    costs: Optional[Dict[str, float]] = None,
    n_workers: int = 2,
    memory_budget_bytes: Optional[int] = None,
    backend: Any = None,
    hierarchy: Any = None,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Dataset-level SA study: many tiles streamed through ONE plan and one
    persistent Manager session (DESIGN.md §10).

    Plans once, then pipelines every tile concurrently through all stages —
    tile A can be in segmentation while tile B normalizes. Returns per-tile
    Dice lists plus the streaming throughput/parallel-efficiency metrics.
    All tiles must share one shape (the plan's byte model is shape-exact).
    ``backend`` picks the session's WorkerBackend, as for
    :func:`run_study`; the single-run reference segmentation always
    executes in-process.
    ``device`` is where the tiles go, once each, and where the task states
    and the reference masks stay: ``None`` means ``cuda:0`` and raises
    without CUDA.
    """
    dev = resolve_device(device)
    images = list(images)
    ref_params = reference_params or TABLE1_SPACE.default()

    t0 = time.perf_counter()
    h, w, raws = _tile_inputs(images, dev, "run_dataset_study")
    wf, plan, cluster = _plan_image_study(
        h, w, param_sets,
        strategy=strategy, max_bucket_size=max_bucket_size,
        active_paths=active_paths, costs=costs, n_workers=n_workers,
        memory_budget_bytes=memory_budget_bytes,
    )
    backend_obj = _backend_for(backend, images, costs, device=device)
    try:
        stream = execute_study(
            plan, raws, cluster=cluster, backend=backend_obj, hierarchy=hierarchy
        )
    finally:
        _backend_cleanup(backend, backend_obj)
    ref_masks = _reference_masks(wf, ref_params, raws, cluster)

    n = len(raws)
    dices = [
        [
            float(dice(stream.outputs[i][rid]["mask"], ref_masks[i]))
            for rid in range(len(param_sets))
        ]
        for i in range(n)
    ]
    return {
        "dice": dices,  # [tile][run]
        "tasks_total": plan.tasks_total * n,
        "tasks_executed": stream.tasks_executed,
        "planned_tasks_executed": plan.tasks_executed * n,
        "cache_hits": stream.cache_hits,
        "cache_misses": stream.cache_misses,
        "cache_spills": stream.cache_spills,
        "reuse_factor": reuse_factor(stream.tasks_executed, plan.tasks_total * n),
        "throughput": stream.throughput,
        "parallel_efficiency": stream.parallel_efficiency,
        "manager_sessions": stream.manager_sessions,
        "backend": stream.backend,
        "dispatch_counts": dict(stream.dispatch_counts),
        "retries": stream.retries,
        "backups_launched": stream.backups_launched,
        "wall_seconds": time.perf_counter() - t0,
        "reference_masks": [m.cpu().numpy() for m in ref_masks],
        "plan": plan,
        "stream": stream,
    }


def run_adaptive_study(
    images: Sequence[np.ndarray],
    *,
    space: ParamSpace = TABLE1_SPACE,
    max_rounds: int = 4,
    strategy: str = "hybrid",
    n_workers: int = 1,
    seed: int = 0,
    reference_params: Optional[ParamSet] = None,
    n_trajectories: int = 2,
    n_base: int = 4,
    n_boot: int = 16,
    costs: Optional[Dict[str, float]] = None,
    store_dir: Optional[str] = None,
    sa_policy: Optional[Any] = None,
    backend: Any = None,
    hierarchy: Any = None,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Adaptive MOAT → prune → VBD → refine study over tiles (DESIGN.md §11).

    A thin caller of :class:`repro_torch.study.StudyDriver`: the objective
    is the Dice *difference* (1 − Dice) of each run's segmentation vs the
    default-parameter reference, averaged over tiles; rounds share one
    Manager session, one result cache backed by the persistent store
    (``store_dir``: a directory, ``"obj:<root>"`` for the object-store
    tier, or ``None`` for a throwaway one), and plan only each round's
    delta against the cached trie. The summary reports the study-wide reuse
    accounting (``reuse_factor``, cache hit/miss/spill counters) alongside
    the per-round records. ``device`` is as for :func:`run_dataset_study`.
    """
    from repro_torch.study import (
        MoatSampler,
        RefinementSampler,
        SaltelliSampler,
        StudyDriver,
    )

    dev = resolve_device(device)
    images = list(images)
    h, w, raws = _tile_inputs(images, dev, "run_adaptive_study")
    wf = build_workflow(h, w, costs)
    cluster = ClusterSpec(n_workers=n_workers)
    ref_masks = _reference_masks(wf, reference_params or space.default(), raws, cluster)

    def objective(leaf_state: Any, input_index: int) -> float:
        return 1.0 - float(dice(leaf_state["mask"], ref_masks[input_index]))

    t0 = time.perf_counter()
    driver = StudyDriver(
        wf,
        space,
        raws,
        objective=objective,
        maximize=False,
        seed=seed,
        engine_policy=strategy,
        cluster=cluster,
        sa_policy=sa_policy,
        samplers={
            "moat": MoatSampler(n_trajectories),
            "vbd": SaltelliSampler(n_base),
            "refine": RefinementSampler(),
        },
        n_boot=n_boot,
        input_keys=[f"tile{i}" for i in range(len(raws))],
        store_dir=store_dir,
        # the workers' spill stores mount the SAME store_dir as the
        # study state, so a resumed study rehydrates worker-computed task
        # outputs too — without it, backend="process" would silently lose
        # the zero-recompute-resume guarantee (the workers' caches are
        # where the results live in spec mode)
        backend=_backend_for(backend, images, costs, store_dir=store_dir, device=device),
        hierarchy=hierarchy,
    )
    try:
        state = driver.run(max_rounds=max_rounds)
        # publish barrier: push the round-persistent cache through to the
        # store's disk tier and report how many entries that persisted. In
        # process-backend mode the leader cache is structurally empty — the
        # workers own the caches and flush them at each round install and
        # again at session shutdown (driver.close below) — so 0 here means
        # the durability lives worker-side, not that results were lost.
        cache_flushed = state.cache.flush()
        summary = driver.summary()
    finally:
        driver.close()
        _backend_cleanup(backend, driver.backend)
    return {
        **summary,
        "cache_flushed": cache_flushed,
        "wall_seconds": time.perf_counter() - t0,
        "rounds_detail": [_round_detail(r) for r in state.rounds],
        "reference_masks": [m.cpu().numpy() for m in ref_masks],
        "state": state,
    }


def _leader_objective(leaf_state: Any, input_index: int) -> float:
    raise RuntimeError(
        "the fleet leader never evaluates; its objective is a placeholder"
    )


def pathology_fleet_build(
    size: int = 48,
    n_tiles: int = 2,
    seed: int = 0,
    space_dict: Optional[Dict[str, list]] = None,
    costs: Optional[Dict[str, float]] = None,
    leader: bool = False,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Spawn-picklable fleet ``build`` for the pathology workflow
    (:func:`repro_torch.study.run_fleet_study`): each fleet process calls
    this once to construct its own workflow, tiles, reference masks and Dice
    objective — everything process-local and deterministic, so every
    process computes identical references (tasks are pure and tiles are
    seeded). With ``leader=True`` (the fleet runner passes it for the
    leader, which proposes/analyzes but never evaluates) the expensive
    reference segmentation is skipped and the objective is a placeholder
    that raises if ever called. ``device`` is resolved in each process, as
    for :func:`pathology_rpc_build`; ``"stats"`` is :func:`_worker_stats`."""
    space = TABLE1_SPACE if space_dict is None else ParamSpace.from_dict(space_dict)
    dev = resolve_device(device)
    wf = build_workflow(size, size, costs)
    tiles = [synthetic_tile(size, size, seed=seed + t) for t in range(n_tiles)]
    raws = [{"raw": torch.as_tensor(im, device=dev)} for im in tiles]
    if leader:
        objective: Any = _leader_objective
    else:
        ref_masks = _reference_masks(wf, space.default(), raws, ClusterSpec())

        def objective(leaf_state: Any, input_index: int) -> float:
            return 1.0 - float(dice(leaf_state["mask"], ref_masks[input_index]))

    return {
        "workflow": wf,
        "space": space,
        "inputs": raws,
        "objective": objective,
        "input_keys": [f"tile{i}" for i in range(n_tiles)],
        "stats": functools.partial(_worker_stats, dev),
    }


def pathology_service_build(
    size: int = 48,
    n_tiles: int = 2,
    seed: int = 0,
    space_dict: Optional[Dict[str, list]] = None,
    costs: Optional[Dict[str, float]] = None,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Build mapping for :class:`repro_torch.service.StudyServer` (and the
    ``python -m repro_torch.service serve --build`` entry): the pathology
    workflow, tiles, reference masks and Dice objective, deterministic in
    ``seed`` so a server restart reconstructs byte-identical references.
    Same shape as :func:`pathology_fleet_build` — the service server IS a
    resident fleet leader that also evaluates, so it always wants the real
    objective (no ``leader`` placeholder). ``device`` is as for
    :func:`pathology_fleet_build`: ``None`` means the card, and raises
    without CUDA."""
    return pathology_fleet_build(
        size=size,
        n_tiles=n_tiles,
        seed=seed,
        space_dict=space_dict,
        costs=costs,
        leader=False,
        device=device,
    )


def run_fleet_study(
    *,
    n_procs: int = 2,
    store_dir: str,
    size: int = 48,
    n_tiles: int = 2,
    space: ParamSpace = TABLE1_SPACE,
    max_rounds: int = 4,
    strategy: str = "hybrid",
    n_workers: int = 1,
    seed: int = 0,
    n_boot: int = 16,
    sa_policy: Optional[Any] = None,
    samplers: Optional[Dict[str, Any]] = None,
    worker_backend: Any = None,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Adaptive pathology study executed by a fleet of ``n_procs``
    StudyDriver processes pooling one :class:`~repro_torch.runtime.SharedStore`
    on ``store_dir`` (DESIGN.md §12).

    Thin caller of :func:`repro_torch.study.run_fleet_study` with the
    pathology ``build``; the returned summary mirrors
    :func:`run_adaptive_study` plus the fleet's cross-process accounting
    (``fleet`` key: combined task counts, corrupt-entry reads — must be 0 —
    lock-elided double-writes, cross-process store rehydrations, and the
    workers' device report summed over them). ``device`` goes to every
    process's build: ``None`` means each process's card, and raises there
    without CUDA.
    """
    from repro_torch.study import run_fleet_study as _run_fleet

    t0 = time.perf_counter()
    state, fleet = _run_fleet(
        pathology_fleet_build,
        {
            "size": size,
            "n_tiles": n_tiles,
            "seed": seed,
            "space_dict": {p.name: list(p.values) for p in space.params},
            "device": device,
        },
        n_procs=n_procs,
        store_dir=store_dir,
        max_rounds=max_rounds,
        seed=seed,
        engine_policy=strategy,
        cluster=ClusterSpec(n_workers=n_workers),
        sa_policy=sa_policy,
        samplers=samplers,
        n_boot=n_boot,
        worker_backend=worker_backend,
    )
    return {
        "rounds": len(state.rounds),
        "tasks_requested": state.tasks_requested,
        "tasks_executed": state.tasks_executed,
        "reuse_factor": reuse_factor(state.tasks_executed, state.tasks_requested),
        "active": list(state.active),
        "frozen": dict(state.frozen),
        "phase": state.phase,
        "best": None
        if state.best is None
        else {"params": dict(state.best[0]), "objective": state.best[1]},
        "fleet": fleet,
        "wall_seconds": time.perf_counter() - t0,
        "rounds_detail": [_round_detail(r) for r in state.rounds],
        "state": state,
    }
