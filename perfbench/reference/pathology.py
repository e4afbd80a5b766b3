"""Plain reference of the pathology workflow: one run's mask, alone.

Each function is the task's equation as the paper's workflow states it
(normalize, then Seg0-Seg6 over the 15 Table I parameters), written here
without the program's kernels, planner or caches. Reconstruction by
dilation is computed by directional sweeps: along a row, the recurrence
``v[x] = min(max(v[x-1], marker[x]), mask[x])`` is a composition of clamp
functions, which is associative, so each sweep is an exact scan of max and
min; sweeps in the four axis directions and one full dilation step repeat
until nothing changes, which is the reconstruction's fixpoint. Connected
components are the same computation on negated pixel indices (the least
index of a component reaches all of it). The watershed's flood keeps the
program's step-by-step order, since which basin reaches a pixel first
decides the split lines.

``dtype`` is the precision of the image arithmetic: float32 as the
workflow states it, or bfloat16 for the control. Labels and sizes are
integers in either case.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

_TARGET_MEAN = (200.0, 160.0, 180.0)
_TARGET_STD = (40.0, 45.0, 40.0)
_NEIGHBOURS = {
    4: ((1, 0), (-1, 0), (0, 1), (0, -1)),
    8: ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)),
}


def shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[i, j] = x[i - dy, j - dx]``, ``fill`` where that is outside."""
    h, w = x.shape
    padded = F.pad(x, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)), value=fill)
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return padded[y0:y0 + h, x0:x0 + w]


def dilate(x: torch.Tensor, conn: int) -> torch.Tensor:
    out = x
    for dy, dx in _NEIGHBOURS[conn]:
        out = torch.maximum(out, shift(x, dy, dx, float("-inf")))
    return out


def erode(x: torch.Tensor, conn: int) -> torch.Tensor:
    out = x
    for dy, dx in _NEIGHBOURS[conn]:
        out = torch.minimum(out, shift(x, dy, dx, float("inf")))
    return out


def _sweep(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Along the last dim, first to last: ``v[x] = min(max(v[x-1], v0[x]),
    mask[x])`` from ``v[-1] = -inf``, as an inclusive scan of the clamps
    ``(lo, hi) = (v0[x], mask[x])``; ``(lo1, hi1)`` then ``(lo2, hi2)`` is
    ``(max(lo1, lo2), min(max(hi1, lo2), hi2))``."""
    lo, hi = v, mask
    n, d = v.shape[-1], 1
    while d < n:
        lo_prev = F.pad(lo[..., :-d], (d, 0), value=float("-inf"))
        hi_prev = F.pad(hi[..., :-d], (d, 0), value=float("inf"))
        lo, hi = torch.maximum(lo_prev, lo), torch.minimum(torch.maximum(hi_prev, lo), hi)
        d *= 2
    return torch.minimum(lo, hi)


def reconstruct(marker: torch.Tensor, mask: torch.Tensor, conn: int) -> torch.Tensor:
    """Grayscale reconstruction by dilation of ``marker`` under ``mask``:
    the least fixpoint above the marker of ``r = min(dilate(r), mask)``."""
    r = torch.minimum(marker, mask)
    mask_t = mask.t()
    while True:
        prev = r
        r = torch.minimum(dilate(r, conn), mask)
        r = _sweep(r, mask)
        r = _sweep(r.flip(-1), mask.flip(-1)).flip(-1)
        r = _sweep(r.t(), mask_t).t()
        r = _sweep(r.t().flip(-1), mask_t.flip(-1)).flip(-1).t()
        if torch.equal(r, prev):
            return r


def label(mask: torch.Tensor, conn: int) -> torch.Tensor:
    """int32 labels: the least flat pixel index of each connected
    component, -1 off the mask."""
    h, w = mask.shape
    off = float(-(2 ** 25))  # below every negated index, exact in float32
    idx = torch.arange(h * w, dtype=torch.float32, device=mask.device).reshape(h, w)
    r = reconstruct(torch.where(mask, -idx, off), torch.where(mask, 0.0, off), conn)
    return torch.where(mask, (-r).to(torch.int32), -1)


def sizes(labels: torch.Tensor) -> torch.Tensor:
    """Each pixel's component size (0 off the mask)."""
    flat = labels.reshape(-1).to(torch.int64)
    n = flat.numel()
    bins = torch.where(flat >= 0, flat, n)
    counts = torch.bincount(bins, minlength=n + 1)
    counts[n] = 0
    return counts[bins].reshape(labels.shape)


def area_filter(mask: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    s = sizes(label(mask, 8))
    return mask & (s >= lo) & (s <= hi)


def fill_holes(mask: torch.Tensor, conn: int, dtype: torch.dtype) -> torch.Tensor:
    """Holes are the complement's parts that the border does not reach."""
    inv = (~mask).to(dtype)
    border = torch.zeros_like(inv)
    border[0, :], border[-1, :] = inv[0, :], inv[-1, :]
    border[:, 0], border[:, -1] = inv[:, 0], inv[:, -1]
    outside = reconstruct(border, inv, conn)
    return mask | (outside < 0.5)


def watershed(mask: torch.Tensor, min_size: int, conn: int, dtype: torch.dtype) -> torch.Tensor:
    """Drop components under ``min_size``, seed at the regional maxima of
    a 64-step erosion count, flood from the seeds one step at a time (a
    pixel takes the least neighbouring seed label when it is first
    reached) and cut the pixels that touch another basin (4-neighbours)."""
    pre = mask & (sizes(label(mask, conn)) >= min_size)
    pre_f = pre.to(dtype)
    cur, dist = pre_f, pre_f
    for _ in range(64):
        cur = erode(cur, 4) * pre_f
        dist = dist + cur
    maxima = (dist >= dilate(dist, conn)) & pre & (dist > 1.0)
    h, w = mask.shape
    big = h * w
    lab = torch.where(maxima, label(maxima, 8), big)
    while True:
        nb = torch.full_like(lab, big)
        for dy, dx in _NEIGHBOURS[conn]:
            nb = torch.minimum(nb, shift(lab, dy, dx, big))
        new = torch.where((lab == big) & pre, nb, lab)
        if torch.equal(new, lab):
            break
        lab = new
    cut = torch.zeros_like(mask)
    for dy, dx in _NEIGHBOURS[4]:
        nb = shift(lab, dy, dx, big)
        cut |= (nb != lab) & (nb != big) & (lab != big)
    return pre & ~cut


def normalize(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-channel standardisation onto the study's target mean and
    standard deviation (the population one)."""
    x = raw.to(dtype)
    mean = x.mean(dim=(0, 1), keepdim=True)
    std = x.std(dim=(0, 1), keepdim=True, correction=0) + 1e-6
    tm = torch.tensor(_TARGET_MEAN, dtype=dtype, device=x.device)
    ts = torch.tensor(_TARGET_STD, dtype=dtype, device=x.device)
    return (x - mean) / std * ts + tm


def segment(rgb: torch.Tensor, p: Dict[str, float]) -> torch.Tensor:
    """Seg0-Seg6 of one parameter set on a normalised tile: the mask."""
    dtype = rgb.dtype
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    fg = ~((b > float(p["B"])) & (g > float(p["G"])) & (r > float(p["R"])))
    rbc = (r / (g + 1.0) > float(p["T1"])) & (r / (b + 1.0) > float(p["T2"]))
    gray = (255.0 - b) * (fg & ~rbc).to(dtype)
    marker = torch.clamp_min(gray - float(p["G1"]), 0.0)
    residual = gray - reconstruct(marker, gray, int(p["RC"]))
    mask = fill_holes(residual > float(p["G2"]) * 0.5, int(p["FH"]), dtype)
    mask = area_filter(mask, int(p["minS"]), int(p["maxS"]))
    mask = watershed(mask, int(p["minSPL"]), int(p["WConn"]), dtype)
    return area_filter(mask, int(p["minSS"]), int(p["maxSS"]))


def dice(a: torch.Tensor, b: torch.Tensor) -> float:
    """Dice of two masks in float32 (1.0 where both are empty). Mask
    sums are whole numbers below 2**24, so float32 holds them exactly and
    the quotient is rounded once."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    inter, total = torch.sum(a * b), torch.sum(a) + torch.sum(b)
    return float(torch.where(total > 0, 2.0 * inter / torch.clamp_min(total, 1e-9), 1.0))


def run_dice(raw: torch.Tensor, runs, default, dtype: torch.dtype = torch.float32
             ) -> Tuple[float, ...]:
    """Each run's Dice against the default set's mask on one tile."""
    rgb = normalize(raw, dtype)
    ref = segment(rgb, dict(default))
    return tuple(dice(segment(rgb, dict(run)), ref) for run in runs)
