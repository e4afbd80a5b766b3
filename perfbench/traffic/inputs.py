"""Inputs made from seeds: pathology tiles, and the order in which a
run's items take them.

``synthetic_tile`` is a frozen copy of ``repro_torch.app.pipeline``'s
generator (pink stroma, purple nuclei, red blood cells and a glass band).
A 4096² tile is an 8×8 mosaic of 512² sub-tiles, as the program's card
checks build it; here each tile is a distinct seeded arrangement, with
flips, of one pool of sub-tiles made once in set-up, so that the pool is
paid for once.
"""

from __future__ import annotations

import concurrent.futures
from typing import List

import numpy as np


def synthetic_tile(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """An (h, w, 3) float32 H&E-like tile in [0, 255]."""
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 215 + rng.normal(0, 6, (h, w))
    img[..., 1] = 170 + rng.normal(0, 6, (h, w))
    img[..., 2] = 195 + rng.normal(0, 6, (h, w))

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

    blobs(max(4, h * w // 1600), 3.0, 9.0, (110, 70, 150))  # nuclei
    blobs(max(2, h * w // 6400), 2.0, 6.0, (190, 60, 70))  # red blood cells
    img[: h // 8, :, :] = 245 + rng.normal(0, 3, (h // 8, w, 3))  # glass
    return np.clip(img, 0, 255).astype(np.float32)


def sub_tile_pool(seed: int, n: int, sub: int) -> np.ndarray:
    """(n, sub, sub, 3) float32: sub-tile i drawn from (seed, i)."""
    def one(i):
        return synthetic_tile(sub, sub, np.random.default_rng([seed, 0, i]))

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        return np.stack(list(pool.map(one, range(n))))


def mosaic(pool: np.ndarray, seed: int, item: int, tile: int, grid: int) -> np.ndarray:
    """A (grid·sub)² tile: the pool's sub-tiles in an order and with flips
    drawn from (seed, item, tile)."""
    rng = np.random.default_rng([seed, 1, item, tile])
    sub = pool.shape[1]
    order = rng.permutation(pool.shape[0])[: grid * grid]
    flips = rng.integers(0, 2, (grid * grid, 2))
    out = np.empty((grid * sub, grid * sub, 3), np.float32)
    for k, (src, (fy, fx)) in enumerate(zip(order, flips)):
        block = pool[src]
        if fy:
            block = block[::-1]
        if fx:
            block = block[:, ::-1]
        r, c = divmod(k, grid)
        out[r * sub:(r + 1) * sub, c * sub:(c + 1) * sub] = block
    return out


def order(seed: int, n: int) -> List[int]:
    """A permutation of ``range(n)`` drawn from the seed."""
    return np.random.default_rng([seed, 4]).permutation(n).tolist()


def sample(seed: int, population: List, k: int, salt: int = 3) -> List:
    """``k`` entries of ``population`` (all where it has fewer) drawn
    from the seed without replacement, in population order."""
    rng = np.random.default_rng([seed, salt])
    if len(population) <= k:
        return list(population)
    keep = sorted(rng.choice(len(population), size=k, replace=False).tolist())
    return [population[i] for i in keep]
