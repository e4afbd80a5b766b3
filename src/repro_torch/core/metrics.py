"""Output-difference metrics (paper §II-A): Dice and Jaccard coefficients
between a run's segmentation mask and the default-parameter reference mask,
as float32 reductions on the masks' device — plus the execution-side
throughput/parallel-efficiency accounting the streaming dataset executor and
the cluster simulator report (paper §IV-D)."""

from __future__ import annotations

import torch

__all__ = [
    "dice",
    "jaccard",
    "throughput",
    "parallel_efficiency",
    "reuse_factor",
]


def throughput(n_items: int, wall_seconds: float) -> float:
    """Completed work items (tiles, batches) per second of wall-clock."""
    return n_items / wall_seconds if wall_seconds > 0 else 0.0


def reuse_factor(tasks_executed: int, tasks_requested: int) -> float:
    """How many requested task executions each actual execution amortised.

    ``tasks_requested`` is the study's naive task count (runs × tasks,
    summed over rounds for adaptive studies); ``tasks_executed`` the
    measured count after dedup, trie merging and result-cache/-store hits.
    1.0 means no reuse; the paper's Table II "Reuse" column is the same
    quantity expressed as a fraction, ``1 - 1/reuse_factor``.
    """
    if tasks_executed <= 0:
        return float("inf") if tasks_requested > 0 else 1.0
    return tasks_requested / tasks_executed


def parallel_efficiency(
    busy_seconds: float, wall_seconds: float, n_workers: int
) -> float:
    """Useful-work fraction of the worker-seconds the run occupied — the
    paper's busy/(makespan × workers) definition (≈0.92 at 256 nodes)."""
    denom = wall_seconds * max(1, n_workers)
    return busy_seconds / denom if denom > 0 else 0.0


def dice(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dice coefficient of two boolean/binary masks, as a 0-d float32
    tensor. Returns 1.0 when both masks are empty (identical-by-vacuity),
    matching common practice."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    inter = torch.sum(a * b)
    sizes = torch.sum(a) + torch.sum(b)
    return torch.where(sizes > 0, 2.0 * inter / torch.clamp_min(sizes, 1e-9), 1.0)


def jaccard(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    inter = torch.sum(a * b)
    union = torch.sum(torch.maximum(a, b))
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-9), 1.0)
