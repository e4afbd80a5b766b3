"""The port's morphology and reconstruction against the JAX package's, exact
(atol=0): the plain PyTorch version against ``morph_reconstruct_ref`` and
against the Pallas kernel in interpret mode, the shift/dilate/erode helpers,
the device dispatch, and (on a card only) the CUDA kernel against its plain
version."""

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
