"""PyTorch implementations of the pathology-pipeline operators (paper Fig 1).

The motivating application normalises a whole-slide H&E tile, segments cell
nuclei through a chain of threshold / morphological operators, and compares
each run's mask with the default-parameter mask (Dice). Every operator below
is a function of ``float32``/``bool``/``int32`` tensors that runs on their
device. Reconstruction by dilation (Seg2, and the fill-holes step of Seg3)
goes through the kernel dispatch of :mod:`repro_torch.kernels.ops`: the CUDA
kernel for tensors on the card, its plain version on the CPU. Both are exact.

Connectivity parameters (FH / RC / WConn in Table I) are 4 or 8 and select
the structuring element. Label and flooding loops run to their fixpoint: on
the card in one launch of the :mod:`repro_torch.kernels.label_prop` kernel,
which makes no host sync; on the CPU in the Python loops below, their plain
versions, with one host sync per step. Each loop is a ``label_loop`` span
whose ``steps`` counts those syncs and whose ``launches`` counts the
kernel's launches. Component sizes, and the size test of the area filters
and of the watershed's ``pre`` mask, are one call of the
:mod:`repro_torch.kernels.component_sizes` kernel on the card and
``torch.bincount``, their plain version, on the CPU; each is a
``component_sizes`` span whose ``launches`` counts the kernel's calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import trace
from repro_torch.kernels import component_sizes as sizes_kernel, label_prop, ops as kops
from repro_torch.kernels.ref import dilate, erode, neighbors as _neighbors, shift2d as _shift

__all__ = [
    "normalize_tile",
    "background_mask",
    "rbc_mask",
    "dilate",
    "erode",
    "morph_reconstruct",
    "fill_holes",
    "label_components",
    "component_sizes",
    "area_filter",
    "distance_transform",
    "watershed_split",
]

_TARGET_MEAN = (200.0, 160.0, 180.0)  # H&E-like reference
_TARGET_STD = (40.0, 45.0, 40.0)


def normalize_tile(rgb: torch.Tensor) -> torch.Tensor:
    """Stain/intensity normalisation: per-channel standardisation onto the
    reference mean/std used across the study (shared by every SA run).
    The std is the population std, as ``jnp.std`` computes it."""
    x = rgb.to(torch.float32)
    mean = torch.mean(x, dim=(0, 1), keepdim=True)
    std = torch.std(x, dim=(0, 1), keepdim=True, correction=0) + 1e-6
    target_mean = torch.tensor(_TARGET_MEAN, dtype=torch.float32, device=x.device)
    target_std = torch.tensor(_TARGET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std * target_std + target_mean


def background_mask(rgb: torch.Tensor, b: float, g: float, r: float) -> torch.Tensor:
    """Background detection (B/G/R thresholds): bright-in-all-channels pixels
    are glass/background. Returns the *foreground* (tissue) mask. The
    thresholds compare as float32."""
    bg = (rgb[..., 2] > b) & (rgb[..., 1] > g) & (rgb[..., 0] > r)
    return ~bg


def rbc_mask(rgb: torch.Tensor, t1: float, t2: float) -> torch.Tensor:
    """Red-blood-cell detection (T1/T2 ratio thresholds): red-dominant pixels
    with R/G > T1 and R/B > T2 are RBCs, excluded from nuclei candidates."""
    r = rgb[..., 0]
    g = rgb[..., 1] + 1.0
    bl = rgb[..., 2] + 1.0
    return (r / g > t1) & (r / bl > t2)


def morph_reconstruct(
    marker: torch.Tensor, mask: torch.Tensor, conn: int = 8
) -> torch.Tensor:
    """Grayscale morphological reconstruction by dilation: iterate
    ``marker ← min(dilate(marker), mask)`` to fixpoint, through the kernel
    dispatch."""
    return kops.morph_reconstruct(marker, mask, conn=conn)


def fill_holes(mask: torch.Tensor, conn: int = 4) -> torch.Tensor:
    """Binary fill-holes via reconstruction of the complement from the border
    (FH parameter selects the propagation neighbourhood)."""
    inv = (~mask).to(torch.float32)
    border = torch.zeros_like(inv)
    border[0, :] = inv[0, :]
    border[-1, :] = inv[-1, :]
    border[:, 0] = inv[:, 0]
    border[:, -1] = inv[:, -1]
    outside = kops.morph_reconstruct(border, inv, conn=conn)
    return mask | (outside < 0.5)


def label_components(mask: torch.Tensor, conn: int = 8) -> torch.Tensor:
    """Connected-component labels by iterative min-label propagation.

    Labels are flat int32 pixel indices (stable, deterministic); background
    = -1. The loop runs until fixpoint — bounded by the component diameter.
    """
    if kops._on_card(mask, None):
        with trace.span("label_loop", "pathology tasks") as sp:
            labels = label_prop.label_components_cuda(mask.contiguous(), conn=conn)
            sp.count(steps=0, launches=1)
        return labels
    h, w = mask.shape
    big = h * w
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, idx, big)
    with trace.span("label_loop", "pathology tasks") as sp:
        steps = 0
        while True:
            new = lab
            for dy, dx in _neighbors(conn):
                new = torch.minimum(new, _shift(lab, dy, dx, big))
            new = torch.where(mask, new, big)
            steps += 1
            if not bool(torch.any(new != lab)):
                break
            lab = new
        sp.count(steps=steps)
    return torch.where(mask, lab, -1)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel int32 size of the component the pixel belongs to (0 for bg)."""
    with trace.span("component_sizes", "pathology tasks") as sp:
        if kops._on_card(labels, None):
            sizes = sizes_kernel.component_sizes_cuda(labels.contiguous())
            sp.count(launches=1)
            return sizes
        sp.count(launches=0)
        h, w = labels.shape
        flat = labels.reshape(-1)
        bins = torch.where(flat >= 0, flat, h * w).to(torch.int64)
        counts = torch.bincount(bins, minlength=h * w + 1)
        counts[h * w] = 0
        return counts[bins].reshape(h, w).to(torch.int32)


def _size_filter(
    mask: torch.Tensor, labels: torch.Tensor, lo: int, hi: Optional[int] = None
) -> torch.Tensor:
    """``mask & (sizes >= lo) & (sizes <= hi)`` for ``labels``, the labels of
    ``mask`` (``hi`` None: no upper bound). On the card one call of the
    kernel, which reads ``labels >= 0`` for ``mask``: ``label_components``
    gives -1 exactly off it."""
    if kops._on_card(labels, None):
        with trace.span("component_sizes", "pathology tasks") as sp:
            keep = sizes_kernel.size_filter_cuda(labels.contiguous(), lo, hi)
            sp.count(launches=1)
        return keep
    sizes = component_sizes(labels)
    keep = mask & (sizes >= lo)
    return keep if hi is None else keep & (sizes <= hi)


def area_filter(
    mask: torch.Tensor, min_size: int, max_size: int, conn: int = 8
) -> torch.Tensor:
    """Drop components outside [min_size, max_size] (MinSize/MaxSize params)."""
    return _size_filter(mask, label_components(mask, conn=conn), min_size, max_size)


def distance_transform(
    mask: torch.Tensor, conn: int = 4, max_iters: int = 64
) -> torch.Tensor:
    """Chamfer-style distance to background by iterated erosion counting:
    exactly ``max_iters`` erosions, not a loop to a fixpoint."""
    maskf = mask.to(torch.float32)
    cur = maskf
    dist = maskf
    for _ in range(max_iters):
        cur = erode(cur, conn=conn) * maskf
        dist = dist + cur
    return dist


def watershed_split(
    mask: torch.Tensor, min_size_pl: int, conn: int = 8
) -> torch.Tensor:
    """Watershed-style splitting of touching nuclei (WConn / MinSizePl).

    Seeds = regional maxima of the distance transform; seeded flood by
    iterative nearest-seed propagation (same engine as the paper's irregular
    wavefront propagation); pixels where two different seeds collide form the
    split lines, which are removed from the mask. Components smaller than
    ``min_size_pl`` are dropped *before* splitting (paper's MinSizePl)."""
    pre = _size_filter(mask, label_components(mask, conn=conn), min_size_pl)
    dist = distance_transform(pre, conn=4)
    maxima = (dist >= dilate(dist, conn=conn)) & pre & (dist > 1.0)
    h, w = mask.shape
    big = h * w
    # merge plateau maxima into one seed per regional maximum
    lab = _flood(torch.where(maxima, label_components(maxima, conn=8), big), pre, conn)
    # split line: a pixel adjacent (4-conn) to a pixel of a different basin
    boundary = torch.zeros_like(mask)
    for dy, dx in _neighbors(4):
        nb = _shift(lab, dy, dx, big)
        boundary = boundary | ((nb != lab) & (nb != big) & (lab != big))
    return pre & ~boundary


def _flood(lab: torch.Tensor, pre: torch.Tensor, conn: int) -> torch.Tensor:
    """Competitive multi-source BFS from the seeds ``lab`` (``h * w`` where
    unlabelled): unlabeled pixels of ``pre`` take the min neighbouring
    label; labelled pixels never change, so basins stop at collision fronts
    (the watershed lines)."""
    with trace.span("label_loop", "pathology tasks") as sp:
        if kops._on_card(lab, None):
            lab = label_prop.flood_cuda(lab, pre.contiguous(), conn=conn)
            sp.count(steps=0, launches=1)
            return lab
        big = lab.numel()
        steps = 0
        while True:
            nb = torch.full_like(lab, big)
            for dy, dx in _neighbors(conn):
                nb = torch.minimum(nb, _shift(lab, dy, dx, big))
            new = torch.where((lab == big) & pre, nb, lab)
            steps += 1
            if not bool(torch.any(new != lab)):
                break
            lab = new
        sp.count(steps=steps)
    return lab
