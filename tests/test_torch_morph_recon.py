"""The port's morphology and reconstruction against the JAX package's, exact
(atol=0): the plain PyTorch version against ``morph_reconstruct_ref`` and
against the Pallas kernel in interpret mode, the plain version of the CUDA
kernel's tiled schedule (``morph_reconstruct_tiled``) and its clamp scan,
the shift/dilate/erode helpers, the device dispatch, and (on a card only)
the CUDA kernel against its plain versions."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import morph_recon, ops as tops, ref as tref


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only test runs where
    jax is not installed."""
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.morph_recon import morph_reconstruct_pallas

    return SimpleNamespace(jnp=jnp, ref=ref, pallas=morph_reconstruct_pallas)


def random_case(h, w, seed):
    """The marker/mask cases of tests/test_kernel_morph_recon.py."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(0, 100, (h, w)).astype(np.float32)
    marker = np.maximum(mask - rng.uniform(5, 40, (h, w)).astype(np.float32), 0)
    for _ in range(max(1, h * w // 256)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        marker[y, x] = mask[y, x]
    return marker, mask


def bridge_case():
    """4- vs 8-connectivity differ on a diagonal bridge."""
    mask = np.zeros((9, 9), np.float32)
    mask[1:4, 1:4] = 1.0
    mask[4, 4] = 1.0
    mask[5:8, 5:8] = 1.0
    marker = np.zeros_like(mask)
    marker[2, 2] = 1.0
    return marker, mask


def serpentine_case(h, w):
    """A one-pixel corridor that snakes down the image: rows 0, 2, 4, ...
    open, joined at the right end and the left end in turn, so its geodesic
    length is about h * w / 2 and crosses every tile of a row many times.
    The mask falls along the corridor (grayscale) and the marker is its
    value at the start, so the reconstruction is the mask along the whole
    corridor: one pixel left behind shows."""
    mask = np.zeros((h, w), np.float32)
    path = []
    for y in range(0, h, 2):
        xs = range(w) if (y // 2) % 2 == 0 else range(w - 1, -1, -1)
        path += [(y, x) for x in xs]
        if y + 1 < h:
            path.append((y + 1, w - 1 if (y // 2) % 2 == 0 else 0))
    for i, (y, x) in enumerate(path):
        mask[y, x] = 1000.0 - 0.01 * i
    marker = np.zeros_like(mask)
    marker[0, 0] = mask[0, 0]
    return marker, mask


def _port(marker, mask, conn):
    return tops.morph_reconstruct(
        torch.from_numpy(marker), torch.from_numpy(mask), conn=conn
    ).numpy()


@pytest.mark.parametrize("h,w", [(16, 16), (24, 40), (32, 32), (64, 48), (65, 33)])
@pytest.mark.parametrize("conn", [4, 8])
def test_plain_matches_jax_ref_and_pallas(jx, h, w, conn):
    marker, mask = random_case(h, w, seed=h * 1000 + w + conn)
    got = _port(marker, mask, conn)
    jnp = jx.jnp
    ref = np.asarray(jx.ref.morph_reconstruct_ref(jnp.asarray(marker), jnp.asarray(mask), conn=conn))
    pallas = np.asarray(
        jx.pallas(
            jnp.asarray(marker), jnp.asarray(mask), conn=conn,
            block=(16, 16), inner_iters=4, interpret=True,
        )
    )
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


@functools.lru_cache(maxsize=None)
def _jax_results(h, w, conn):
    """JAX's oracle and Pallas kernel (interpret mode) on a ``random_case``."""
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.morph_recon import morph_reconstruct_pallas

    marker, mask = random_case(h, w, seed=h * 1000 + w + conn)
    want = np.asarray(ref.morph_reconstruct_ref(jnp.asarray(marker), jnp.asarray(mask), conn=conn))
    pallas = np.asarray(morph_reconstruct_pallas(
        jnp.asarray(marker), jnp.asarray(mask), conn=conn,
        block=(16, 16), inner_iters=4, interpret=True,
    ))
    return want, pallas


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("h,w", [(16, 16), (24, 40), (32, 32), (64, 48), (65, 33)])
@pytest.mark.parametrize("conn", [4, 8])
def test_tiled_matches_jax_ref_and_pallas(jx, h, w, conn, tile):
    marker, mask = random_case(h, w, seed=h * 1000 + w + conn)
    got = tref.morph_reconstruct_tiled(torch.from_numpy(marker), torch.from_numpy(mask),
                                       conn, tile)
    want, pallas = _jax_results(h, w, conn)
    np.testing.assert_array_equal(got.result.numpy(), want)
    np.testing.assert_array_equal(got.result.numpy(), pallas)
    n_tiles = -(-h // tile) * -(-w // tile)
    assert got.rounds >= 1 and n_tiles <= got.tile_visits <= n_tiles * got.rounds


@pytest.mark.parametrize("tile", [8, 16, 32, (2, 4), (16, 128)])
@pytest.mark.parametrize("conn", [4, 8])
def test_tiled_bridge_case(jx, conn, tile):
    marker, mask = bridge_case()
    got = tref.morph_reconstruct_tiled(torch.from_numpy(marker), torch.from_numpy(mask),
                                       conn, tile).result.numpy()
    want = jx.ref.morph_reconstruct_ref(jx.jnp.asarray(marker), jx.jnp.asarray(mask), conn=conn)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[6, 6] == (1.0 if conn == 8 else 0.0)


@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("conn", [4, 8])
def test_tiled_long_path(jx, conn, tile):
    """The serpentine corridor of a 64×64 mask, about 2,100 pixels long:
    the tiled schedule is exact, and it skips settled tiles (fewer visits
    than tiles × rounds)."""
    marker, mask = serpentine_case(64, 64)
    got = tref.morph_reconstruct_tiled(torch.from_numpy(marker), torch.from_numpy(mask),
                                       conn, tile)
    jm, jk = jx.jnp.asarray(marker), jx.jnp.asarray(mask)
    want = np.asarray(jx.ref.morph_reconstruct_ref(jm, jk, conn=conn))
    pallas = np.asarray(jx.pallas(jm, jk, conn=conn, block=(64, 64), inner_iters=64,
                                  interpret=True))
    np.testing.assert_array_equal(got.result.numpy(), want)
    np.testing.assert_array_equal(got.result.numpy(), pallas)
    np.testing.assert_array_equal(want, mask)  # the whole corridor is reached
    n_tiles = (64 // tile) ** 2
    assert got.rounds > 64 // tile  # the front crosses the tiles many times
    assert got.tile_visits < n_tiles * got.rounds


def test_tiled_rounds_skip_and_cap():
    """A tile settles or waits for the next round: with the cap at two
    passes the serpentine takes more rounds than with eight, and the same
    result."""
    marker, mask = (torch.from_numpy(a) for a in serpentine_case(32, 32))
    two = tref.morph_reconstruct_tiled(marker, mask, 8, 16, max_passes=2)
    eight = tref.morph_reconstruct_tiled(marker, mask, 8, 16, max_passes=8)
    assert torch.equal(two.result, eight.result)
    assert torch.equal(two.result, tref.morph_reconstruct_ref(marker, mask, 8))
    assert two.rounds > eight.rounds
    with pytest.raises(ValueError):
        tref.morph_reconstruct_tiled(marker, mask, 8, 16, max_passes=1)


@pytest.mark.parametrize("n", [1, 2, 5, 32, 33, 128])
def test_clamp_scan_equals_sequential_recurrence(n):
    """The clamp-composition scan against ``v[x] = min(max(v[x-1], a[x]),
    b[x])`` run one element at a time, exact, on random rows with ±inf
    fills and every kind of carry."""
    rng = np.random.default_rng(n)
    rows = 64
    a = rng.uniform(-50, 50, (rows, n)).astype(np.float32)
    b = rng.uniform(-50, 50, (rows, n)).astype(np.float32)
    for arr in (a, b):
        arr[rng.random((rows, n)) < 0.15] = -np.inf
        arr[rng.random((rows, n)) < 0.15] = np.inf
    a[0], b[1] = -np.inf, np.inf  # identity-like rows
    carry = rng.uniform(-60, 60, rows).astype(np.float32)
    carry[:3] = (-np.inf, np.inf, 0.0)
    acc, lim = tref.clamp_scan(torch.from_numpy(a), torch.from_numpy(b))
    got = torch.minimum(torch.maximum(torch.from_numpy(carry)[:, None], acc), lim).numpy()
    want = np.empty_like(a)
    v = carry.copy()
    for x in range(n):
        v = np.minimum(np.maximum(v, a[:, x]), b[:, x])
        want[:, x] = v
    np.testing.assert_array_equal(got, want)


def test_binary_reconstruction_connectivity(jx):
    marker, mask = bridge_case()
    r4, r8 = _port(marker, mask, 4), _port(marker, mask, 8)
    assert r4[6, 6] == 0.0 and r8[6, 6] == 1.0
    for conn, got in ((4, r4), (8, r8)):
        ref = jx.ref.morph_reconstruct_ref(jx.jnp.asarray(marker), jx.jnp.asarray(mask), conn=conn)
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("dy,dx", [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1), (2, -3)])
def test_shift2d_exact(jx, dy, dx):
    rng = np.random.default_rng(100 + dy * 10 + dx)
    x = rng.normal(size=(7, 9)).astype(np.float32)
    lab = rng.integers(0, 63, (7, 9)).astype(np.int32)
    for arr, fill in ((x, -np.inf), (x, np.inf), (lab, 63)):
        want = np.asarray(jx.ref.shift2d(jx.jnp.asarray(arr), dy, dx, fill))
        got = tref.shift2d(torch.from_numpy(arr), dy, dx, fill).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("op", ["dilate", "erode"])
def test_dilate_erode_exact(jx, conn, op):
    x = np.random.default_rng(conn).normal(size=(13, 21)).astype(np.float32)
    want = np.asarray(getattr(jx.ref, op)(jx.jnp.asarray(x), conn=conn))
    got = getattr(tref, op)(torch.from_numpy(x), conn=conn).numpy()
    np.testing.assert_array_equal(got, want)


def test_dispatch_sends_cpu_tensors_to_plain_version():
    marker, mask = random_case(24, 40, seed=5)
    before = morph_recon.LAUNCHES.value
    got = tops.morph_reconstruct(torch.from_numpy(marker), torch.from_numpy(mask), conn=8)
    assert morph_recon.LAUNCHES.value == before
    want = tref.morph_reconstruct_ref(torch.from_numpy(marker), torch.from_numpy(mask), conn=8)
    assert torch.equal(got, want)


def test_dispatch_refuses_kernel_on_cpu():
    marker, mask = random_case(8, 8, seed=1)
    with pytest.raises(ValueError):
        tops.morph_reconstruct(
            torch.from_numpy(marker), torch.from_numpy(mask), use_kernel=True
        )


def test_kernel_wrapper_refuses_cpu_tensors():
    marker, mask = random_case(8, 8, seed=1)
    with pytest.raises(ValueError):
        morph_recon.morph_reconstruct_cuda(torch.from_numpy(marker), torch.from_numpy(mask))


@pytest.mark.gpu
@pytest.mark.parametrize("conn", [4, 8])
def test_cuda_kernel_matches_plain(conn):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [random_case(h, w, seed=h + w + conn) for h, w in [(65, 33), (1, 1), (31, 1000), (512, 512)]]
    cases.append(bridge_case())
    for marker, mask in cases:
        mk, ms = torch.from_numpy(marker).cuda(), torch.from_numpy(mask).cuda()
        before = morph_recon.LAUNCHES.value
        got = tops.morph_reconstruct(mk, ms, conn=conn)
        torch.cuda.synchronize()
        assert morph_recon.LAUNCHES.value > before
        assert torch.equal(got, tref.morph_reconstruct_ref(mk, ms, conn=conn))


def _card_cases(conn):
    cases = [random_case(h, w, seed=h + w + conn) for h, w in [(65, 33), (31, 1000), (512, 512)]]
    cases += [bridge_case(), serpentine_case(128, 256)]
    return [(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()) for a, b in cases]


@pytest.mark.gpu
@pytest.mark.parametrize("conn", [4, 8])
def test_cuda_kernel_repeats_equal(conn):
    """The visits' order and the halo values they read change from call to
    call; the result must not: five calls of each case, each equal to the
    plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for mk, ms in _card_cases(conn):
        want = tref.morph_reconstruct_ref(mk, ms, conn=conn)
        tiled = tref.morph_reconstruct_tiled(mk, ms, conn, morph_recon.TILE)
        assert torch.equal(tiled.result, want)
        for _ in range(5):
            assert torch.equal(morph_recon.morph_reconstruct_cuda(mk, ms, conn=conn), want)


@pytest.mark.gpu
@pytest.mark.parametrize("conn", [4, 8])
def test_cuda_kernel_counts_show_skipping(conn):
    """One launch a call and no wait on the card inside it; the rounds and
    tile visits the kernel counts on the card show settled tiles skipped on
    the long path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert morph_recon.kernel_tile()[:2] == morph_recon.TILE
    mk, ms = _card_cases(conn)[-1]  # the serpentine, 8 x 2 tiles
    counts = (morph_recon.LAUNCHES, morph_recon.ROUNDS, morph_recon.TILE_VISITS)
    before = [c.value for c in counts]
    torch.cuda._sleep(50_000_000)  # the stream stays busy for some milliseconds
    got = morph_recon.morph_reconstruct_cuda(mk, ms, conn=conn)
    assert not torch.cuda.current_stream().query()  # the call did not wait for the card
    launches, rounds, visits = (c.value - b for c, b in zip(counts, before))
    assert torch.equal(got, ms)  # the corridor is reached to its end
    th, tw = morph_recon.TILE
    n_tiles = -(-128 // th) * -(-256 // tw)
    assert launches == 1
    assert rounds > 128 // 2 // th  # the front crosses the tiles many times
    assert n_tiles <= visits < n_tiles * rounds


@pytest.mark.gpu
def test_cuda_grid_over_occupancy_limit_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mk, ms = (torch.from_numpy(a).cuda() for a in random_case(64, 64, seed=3))
    limit, _ = morph_recon.max_blocks(8)
    assert limit > 0
    with pytest.raises(RuntimeError, match="resident"):
        morph_recon._launch(mk, ms, 8, grid_blocks=limit + 1)
    # the grid at the limit runs
    got = morph_recon._launch(mk, ms, 8, grid_blocks=limit)
    assert torch.equal(got, tref.morph_reconstruct_ref(mk, ms, conn=8))
