"""The plain references against the program's operators at small sizes on
the CPU: the sweeps' reconstruction and labels against plain iteration,
and one run's mask and Dice against the program's study."""

import numpy as np
import pytest
import torch

from perfbench.reference import pathology as ref
from perfbench.traffic import inputs, params


def _recon_case(h, w, seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(0, 100, (h, w)).astype(np.float32)
    marker = np.maximum(mask - rng.uniform(5, 40, (h, w)).astype(np.float32), 0)
    for _ in range(max(1, h * w // 256)):
        marker[rng.integers(0, h), rng.integers(0, w)] = mask[0, 0]
    return torch.from_numpy(marker), torch.from_numpy(mask)


def _plain_reconstruct(marker, mask, conn):
    m = torch.minimum(marker, mask)
    while True:
        new = torch.minimum(ref.dilate(m, conn), mask)
        if torch.equal(new, m):
            return m
        m = new


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (64, 64), (40, 97)])
def test_reconstruct_equals_plain_iteration(conn, shape):
    marker, mask = _recon_case(*shape, seed=sum(shape) + conn)
    assert torch.equal(ref.reconstruct(marker, mask, conn), _plain_reconstruct(marker, mask, conn))


def test_reconstruct_follows_a_serpentine():
    mask = torch.zeros(33, 33)
    for r in range(0, 33, 4):
        mask[r, :] = 1.0
    for k, r in enumerate(range(1, 33, 4)):
        col = 32 if k % 2 == 0 else 0
        mask[r:r + 3, col] = 1.0
    marker = torch.zeros_like(mask)
    marker[0, 0] = 1.0
    assert torch.equal(ref.reconstruct(marker, mask, 4), mask)


@pytest.mark.parametrize("conn", [4, 8])
def test_labels_equal_the_programs(conn):
    from repro_torch.app import ops

    rng = np.random.default_rng(conn)
    mask = torch.from_numpy(rng.random((57, 61)) < 0.45)
    assert torch.equal(ref.label(mask, conn), ops.label_components(mask, conn=conn))


def test_masks_and_dice_equal_the_programs_study():
    from repro_torch.app import pipeline

    pool = inputs.sub_tile_pool(5, 4, 64)
    tile = inputs.mosaic(pool, 5, 0, 0, 2)
    sets = params.item_sets({"design": "morris", "design_seed": 0})[:6]
    got = pipeline.run_dataset_study([tile], sets, reference_params=params.default_set(),
                                     device="cpu")["dice"][0]
    want = ref.run_dice(torch.from_numpy(tile), sets, params.default_set())
    assert list(want) == got
    assert len(set(got)) > 1 and min(got) < 1.0


def test_bfloat16_reference_departs():
    pool = inputs.sub_tile_pool(6, 4, 64)
    tile = torch.from_numpy(inputs.mosaic(pool, 6, 0, 0, 2))
    sets = params.item_sets({"design": "morris", "design_seed": 0})[:4]
    full = ref.run_dice(tile, sets, params.default_set())
    low = ref.run_dice(tile, sets, params.default_set(), torch.bfloat16)
    assert max(abs(a - b) for a, b in zip(full, low)) > 0

