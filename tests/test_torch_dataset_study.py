"""The port's dataset and adaptive studies on the CPU against the JAX
package's, on the same numpy tiles made from a seed.

``run_dataset_study``: equal per-tile Dice lists, equal ``tasks_total`` and
``planned_tasks_executed``, and with one worker equal measured counts. With
two workers the measured counts depend on which worker finishes first, so
they are held to the plan (executed + hits == planned), not to JAX.
``run_adaptive_study``: for a fixed seed, equal round kinds, proposed
parameter sets, objective vectors, survivors, best point and per-round
``_round_detail`` (counts, indices, decisions). Tolerance: none. At these
sizes every Dice value and every objective comes out bit-equal to JAX's, and
the tests compare with ``==``.

A card-only test holds ``morph_recon`` launched from two threads on two
streams at once (the dataset study's two workers) to its plain version, and
checks that its launch and device counts hold every call.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.app import TABLE1_SPACE, run_adaptive_study, run_dataset_study, synthetic_tile
from repro_torch.app.pipeline import _round_detail
from repro_torch.core import halton_sequence

SIZE = 32


@pytest.fixture(scope="module")
def tiles():
    return [synthetic_tile(SIZE, SIZE, seed=s) for s in (1, 2, 3)]


@pytest.fixture(scope="module")
def param_sets():
    sets = TABLE1_SPACE.quantise(halton_sequence(6, TABLE1_SPACE.dim))
    return [TABLE1_SPACE.default()] + list(sets)


def _jax():
    """The JAX package's entry points, imported where they are used: the
    card-only test below runs where there is no jax."""
    from repro.app import run_adaptive_study as j_adaptive, run_dataset_study as j_dataset

    return j_dataset, j_adaptive


@pytest.fixture(scope="module")
def jax_dataset(tiles, param_sets):
    return _jax()[0](tiles, param_sets, n_workers=1)


@pytest.fixture(scope="module")
def torch_dataset(tiles, param_sets):
    return run_dataset_study(tiles, param_sets, n_workers=1, device="cpu")


class TestDatasetStudy:
    def test_dice_equal_per_tile(self, jax_dataset, torch_dataset, tiles):
        assert len(torch_dataset["dice"]) == len(tiles)
        assert torch_dataset["dice"] == jax_dataset["dice"]
        for got, want in zip(torch_dataset["reference_masks"], jax_dataset["reference_masks"]):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("key", ["tasks_total", "planned_tasks_executed", "tasks_executed",
                                     "cache_hits", "cache_misses", "cache_spills",
                                     "manager_sessions", "retries", "backups_launched"])
    def test_counts_equal_with_one_worker(self, jax_dataset, torch_dataset, key):
        assert torch_dataset[key] == jax_dataset[key]

    def test_default_set_is_the_reference(self, torch_dataset):
        assert all(row[0] == 1.0 for row in torch_dataset["dice"])

    def test_one_session_and_plan_scaled_by_tiles(self, torch_dataset, tiles):
        plan = torch_dataset["plan"]
        assert torch_dataset["manager_sessions"] == 1
        assert torch_dataset["tasks_total"] == plan.tasks_total * len(tiles)
        assert torch_dataset["planned_tasks_executed"] == plan.tasks_executed * len(tiles)

    @pytest.mark.parametrize("strategy", ["rmsr", "hybrid"])
    def test_two_workers(self, tiles, param_sets, jax_dataset, strategy):
        """The default two workers: Dice equal to JAX's with one worker (the
        outputs do not depend on dispatch or strategy); the measured counts
        cover the plan exactly, whichever attempt of a bucket won."""
        out = run_dataset_study(tiles, param_sets, strategy=strategy, device="cpu")
        want = _jax()[0](tiles, param_sets, strategy=strategy)
        assert out["dice"] == jax_dataset["dice"] == want["dice"]
        for key in ("tasks_total", "planned_tasks_executed"):
            assert out[key] == want[key], key
        assert out["tasks_executed"] + out["cache_hits"] == out["planned_tasks_executed"]

    def test_default_device_is_the_card(self, tiles):
        if torch.cuda.is_available():
            pytest.skip("checks the CUDA-less refusal")
        with pytest.raises(RuntimeError, match="CUDA"):
            run_dataset_study(tiles, [TABLE1_SPACE.default()])
        with pytest.raises(RuntimeError, match="CUDA"):
            run_adaptive_study(tiles)

    @pytest.mark.parametrize("n_workers", [1, 2])
    def test_the_study_frees_its_tensors_on_return(self, tiles, param_sets, monkeypatch,
                                                   n_workers):
        """No task output outlives the call in a reference cycle: with the
        cyclic collector off, every normalized tile is freed once the
        result is dropped (on the card a cycle held an item's cache, its
        normalized tiles and masks, into the next item)."""
        import gc
        import weakref

        from repro_torch.app import ops

        made = []
        normalize = ops.normalize_tile

        def kept(rgb):
            out = normalize(rgb)
            made.append(weakref.ref(out))
            return out

        monkeypatch.setattr(ops, "normalize_tile", kept)
        gc.collect()
        gc.disable()
        try:
            out = run_dataset_study(tiles, param_sets, n_workers=n_workers, device="cpu")
            assert len(made) == 2 * len(tiles)  # the study's and the reference's
            del out
            alive = sum(r() is not None for r in made)
        finally:
            gc.enable()
        assert alive == 0

    @pytest.mark.parametrize("entry", [run_dataset_study, run_adaptive_study])
    def test_tiles_checked_as_the_reference_does(self, entry):
        args = [] if entry is run_adaptive_study else [[TABLE1_SPACE.default()]]
        with pytest.raises(ValueError, match="at least one tile"):
            entry([], *args, device="cpu")
        mixed = [synthetic_tile(8, 8, seed=0), synthetic_tile(8, 12, seed=0)]
        with pytest.raises(ValueError, match="one \\(h, w\\) shape"):
            entry(mixed, *args, device="cpu")


ADAPTIVE = [
    # (seed, tiles, rounds, trajectories, base)
    (1, 2, 3, 2, 4),
    (5, 3, 3, 1, 2),
]


@pytest.fixture(scope="module", params=ADAPTIVE, ids=lambda c: f"seed{c[0]}-tiles{c[1]}")
def adaptive_pair(request, tiles):
    seed, n_tiles, rounds, n_traj, n_base = request.param
    kw = dict(max_rounds=rounds, n_trajectories=n_traj, n_base=n_base, seed=seed)
    want = _jax()[1](tiles[:n_tiles], **kw)
    got = run_adaptive_study(tiles[:n_tiles], device="cpu", **kw)
    return want, got


class TestAdaptiveStudy:
    def test_round_kinds_and_param_sets(self, adaptive_pair):
        want, got = adaptive_pair
        kinds = [r.kind for r in got["state"].rounds]
        assert kinds == [r.kind for r in want["state"].rounds]
        assert kinds[:2] == ["moat", "vbd"]
        for a, b in zip(got["state"].rounds, want["state"].rounds):
            assert a.param_sets == b.param_sets
            assert a.meta == b.meta

    def test_objectives_bit_equal(self, adaptive_pair):
        want, got = adaptive_pair
        for a, b in zip(got["state"].rounds, want["state"].rounds):
            assert a.outputs == b.outputs, a.kind
        assert got["state"].evaluated == want["state"].evaluated
        assert got["best"] == want["best"]

    def test_survivors_and_frozen(self, adaptive_pair):
        want, got = adaptive_pair
        assert got["active"] == want["active"]
        assert got["frozen"] == want["frozen"]
        assert got["phase"] == want["phase"]

    def test_round_detail_equal(self, adaptive_pair):
        want, got = adaptive_pair
        assert got["rounds_detail"] == want["rounds_detail"]
        assert [_round_detail(r) for r in got["state"].rounds] == got["rounds_detail"]

    @pytest.mark.parametrize("key", ["rounds", "tasks_requested", "tasks_executed",
                                     "reuse_factor", "cache_hits", "cache_misses",
                                     "cache_spills", "ledger_paths"])
    def test_study_counters_equal(self, adaptive_pair, key):
        want, got = adaptive_pair
        assert got[key] == want[key]

    def test_reference_masks_equal(self, adaptive_pair):
        want, got = adaptive_pair
        for a, b in zip(got["reference_masks"], want["reference_masks"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_morph_recon_from_two_streams_at_once():
    """Two threads, each on its own stream, launch the cooperative kernel at
    once, as the dataset study's two workers may: every result equals the
    plain version, nothing deadlocks, the launch count is that of the same
    calls made one after another, and the round and tile-visit counts the
    kernels add on the card hold every call's share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import morph_recon

    rng = np.random.default_rng(0)
    cases = []
    for h, w in [(512, 512), (300, 700)]:
        mask = rng.uniform(0, 100, (h, w)).astype(np.float32)
        marker = np.maximum(mask - rng.uniform(5, 40, (h, w)).astype(np.float32), 0)
        cases.append(tuple(torch.from_numpy(a).cuda() for a in (marker, mask)))
    wants = [morph_recon.morph_reconstruct_ref(mk, ms, conn=8) for mk, ms in cases]
    counts = (morph_recon.LAUNCHES, morph_recon.ROUNDS, morph_recon.TILE_VISITS)
    reps = 8

    def one_after_another():
        for _ in range(reps):
            for mk, ms in cases:
                morph_recon.morph_reconstruct_cuda(mk, ms, conn=8)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    before = [c.value for c in counts]
    one_after_another()
    serial = [c.value - b for c, b in zip(counts, before)]

    results = [[], []]

    def worker(slot):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for _ in range(reps // 2):
                results[slot] += [morph_recon.morph_reconstruct_cuda(mk, ms, conn=8)
                                  for mk, ms in cases]
        stream.synchronize()

    before = [c.value for c in counts]
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a launch did not return"
    torch.cuda.synchronize()
    concurrent = [c.value - b for c, b in zip(counts, before)]
    for got in results:
        assert len(got) == reps // 2 * len(cases)
        for i, g in enumerate(got):
            assert torch.equal(g, wants[i % len(cases)])
    assert concurrent[0] == serial[0] == reps * len(cases)
    # rounds and visits depend on the order of the visits, so the two runs
    # need not agree; but every call runs a round and visits each of its
    # tiles in it, so both counts hold every call's share
    th, tw = morph_recon.TILE
    tiles = sum(-(-mk.shape[0] // th) * -(-mk.shape[1] // tw) for mk, _ in cases)
    for got in (serial, concurrent):
        assert got[1] >= reps * len(cases) and got[2] >= reps * tiles
