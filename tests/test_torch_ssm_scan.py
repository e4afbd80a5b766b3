"""The port's diagonal-gated linear recurrence against the JAX package's, at
the TPU kernel's own bar (2e-4; 3e-4 for the chunk-size sweep): the plain
versions against ``ssm_scan_ref``, ``ssm_scan_xla`` and the Pallas kernel in
interpret mode on the cases of tests/test_kernel_ssm_scan.py, the stub, the
device dispatch, and (on a card only) the CUDA kernel against its plain
versions."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops, ref as tref, ssm_scan as tkernel

SHAPES = [
    (1, 16, 1, 4, 4, 8),
    (2, 32, 2, 8, 16, 8),
    (1, 33, 1, 8, 8, 16),  # non-multiple seq length (padding path)
    (1, 64, 3, 16, 32, 64),
]
# (s, chunk, per_channel, seed): a fixed sweep over chunk sizes
SWEEP = [(4, 4, False, 0), (17, 8, True, 11), (33, 32, False, 5), (50, 16, True, 123),
         (64, 4, True, 7), (70, 32, True, 999), (9, 16, False, 42)]


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only tests run where jax
    is not installed."""
    import jax.numpy as jnp

    from repro.kernels import ref
    from repro.kernels.ssm_scan import ssm_scan_pallas

    return SimpleNamespace(jnp=jnp, ref=ref, pallas=ssm_scan_pallas)


def case(b, s, h, n, p, per_channel, seed):
    """The inputs of tests/test_kernel_ssm_scan.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    a_shape = (b, s, h, n) if per_channel else (b, s, h)
    a = np.exp(-np.exp(rng.normal(-1.0, 0.7, a_shape))).astype(np.float32)  # (0,1)
    bb = rng.normal(0, 0.5, (b, s, h, n)).astype(np.float32)
    c = rng.normal(0, 0.5, (b, s, h, n)).astype(np.float32)
    return x, a, bb, c


def strong_decay_case():
    b, s, h, n, p = 1, 48, 1, 8, 8
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    a = np.full((b, s, h, n), 1e-6, np.float32)  # brutal decay
    bb = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
    c = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
    return x, a, bb, c


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("per_channel", [False, True], ids=["mamba2", "rwkv6"])
@pytest.mark.parametrize("b,s,h,n,p,chunk", SHAPES)
def test_plain_versions_match_jax(jx, per_channel, b, s, h, n, p, chunk):
    arrays = case(b, s, h, n, p, per_channel, seed=s * 7 + n)
    j = [jx.jnp.asarray(a) for a in arrays]
    y_ref, h_ref = jx.ref.ssm_scan_ref(*j)
    y_xla, h_xla = jx.ref.ssm_scan_xla(*j, chunk=chunk)
    y_pl, h_pl = jx.pallas(*j, chunk=chunk, interpret=True)
    y_c, h_c = tops.ssm_scan(*_t(arrays), chunk=chunk)
    y_r, h_r = tref.ssm_scan_ref(*_t(arrays))
    assert y_c.dtype == torch.float32 and h_c.shape == (b, h, n, p)
    for want_y, want_h in ((y_ref, h_ref), (y_xla, h_xla), (y_pl, h_pl)):
        _close(y_c, want_y)
        _close(h_c, want_h)
    _close(y_r, y_ref)
    _close(h_r, h_ref)


def test_strong_decay_stability(jx):
    arrays = strong_decay_case()
    y_ref, _ = jx.ref.ssm_scan_ref(*[jx.jnp.asarray(a) for a in arrays])
    y, _ = tops.ssm_scan(*_t(arrays), chunk=16)
    assert torch.isfinite(y).all()
    _close(y, y_ref)


@pytest.mark.parametrize("s,chunk,per_channel,seed", SWEEP)
def test_chunk_invariance(jx, s, chunk, per_channel, seed):
    arrays = case(1, s, 2, 4, 8, per_channel, seed)
    y_ref, _ = jx.ref.ssm_scan_ref(*[jx.jnp.asarray(a) for a in arrays])
    y, _ = tops.ssm_scan(*_t(arrays), chunk=chunk)
    _close(y, y_ref, tol=3e-4)


def test_initial_state_matches_jax_oracle(jx):
    """The plain versions take h0, as ssm_scan_ref does; the kernel does
    not (see test_kernel_path_refuses_h0)."""
    arrays = case(1, 20, 2, 4, 8, True, seed=3)
    h0 = np.random.default_rng(4).normal(0, 1, (1, 2, 4, 8)).astype(np.float32)
    y_ref, h_ref = jx.ref.ssm_scan_ref(*[jx.jnp.asarray(a) for a in (*arrays, h0)])
    for y, hf in (tops.ssm_scan(*_t(arrays), torch.from_numpy(h0), chunk=8),
                  tref.ssm_scan_ref(*_t(arrays), torch.from_numpy(h0))):
        _close(y, y_ref)
        _close(hf, h_ref)


def test_bf16_inputs_match_jax_chunked(jx):
    """bf16 x/b/c with fp32 a, as the RWKV-6 block passes them: y comes
    back in bf16 (one rounding of the same fp32 sums), h_final in fp32."""
    jnp = jx.jnp
    x, a, bb, c = case(1, 40, 2, 8, 8, True, seed=9)
    jb = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, bb, c)]
    y_j, h_j = jx.ref.ssm_scan_xla(jb[0], jnp.asarray(a), jb[1], jb[2], chunk=16)
    tb = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, bb, c)]
    y_t, h_t = tops.ssm_scan(tb[0], torch.from_numpy(a), tb[1], tb[2], chunk=16)
    assert y_t.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    _close(h_t, h_j)
    # a sum within 2e-4 may still round to the neighbouring bf16 value
    np.testing.assert_allclose(
        y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32)), rtol=8e-3, atol=8e-3
    )


@pytest.mark.parametrize("per_channel", [False, True])
def test_stub_matches_jax_stub(jx, per_channel):
    arrays = case(2, 5, 3, 4, 6, per_channel, seed=1)
    y_j, h_j = jx.ref.ssm_scan_stub(*[jx.jnp.asarray(a) for a in arrays])
    y_t, h_t = tops.ssm_scan(*_t(arrays), analysis=True)
    assert tuple(y_t.shape) == y_j.shape == (2, 5, 3, 6)
    assert tuple(h_t.shape) == h_j.shape == (2, 3, 4, 6)
    assert h_t.dtype == torch.float32
    _close(y_t, y_j, tol=1e-6)
    _close(h_t, h_j, tol=1e-6)


def test_dispatch_sends_cpu_tensors_to_plain_version():
    arrays = _t(case(1, 33, 1, 8, 8, True, seed=2))
    before = tkernel.LAUNCHES.value
    y, hf = tops.ssm_scan(*arrays, chunk=16)
    assert tkernel.LAUNCHES.value == before
    y2, h2 = tref.ssm_scan_chunked(*arrays, chunk=16)
    assert torch.equal(y, y2) and torch.equal(hf, h2)
    y3, _ = tops.ssm_scan(*arrays, chunk=16, use_kernel=False)
    assert torch.equal(y, y3)


def test_dispatch_refuses_kernel_on_cpu():
    with pytest.raises(ValueError):
        tops.ssm_scan(*_t(case(1, 8, 1, 4, 4, True, seed=0)), use_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        tkernel.ssm_scan_cuda(*_t(case(1, 8, 1, 4, 4, True, seed=0)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_kernel_path_refuses_h0(card):
    x, a, bb, c = (t.to(card) for t in _t(case(1, 8, 1, 4, 4, True, seed=0)))
    with pytest.raises(NotImplementedError):
        tops.ssm_scan(x, a, bb, c, torch.zeros(1, 1, 4, 4, device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("per_channel", [False, True], ids=["mamba2", "rwkv6"])
def test_cuda_kernel_matches_plain(card, per_channel):
    cases = [(case(b, s, h, n, p, per_channel, seed=s * 7 + n), chunk)
             for b, s, h, n, p, chunk in SHAPES]
    cases += [(case(1, s, 2, 4, 8, per_channel, seed), chunk) for s, chunk, _, seed in SWEEP]
    cases.append((strong_decay_case(), 16))
    for arrays, chunk in cases:
        t = [v.to(card) for v in _t(arrays)]
        before = tkernel.LAUNCHES.value
        y, hf = tops.ssm_scan(*t, chunk=chunk)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES.value == before + 1
        for want_y, want_h in (tref.ssm_scan_ref(*t), tref.ssm_scan_chunked(*t, chunk=chunk)):
            _close(y.cpu(), want_y.cpu(), tol=3e-4)
            _close(hf.cpu(), want_h.cpu(), tol=3e-4)


@pytest.mark.gpu
def test_cuda_kernel_bf16(card):
    x, a, bb, c = case(1, 200, 4, 64, 64, True, seed=5)
    tb = [torch.from_numpy(v).to(card, torch.bfloat16) for v in (x, bb, c)]
    ta = torch.from_numpy(a).to(card)
    y, hf = tops.ssm_scan(tb[0], ta, tb[1], tb[2])
    y_p, h_p = tref.ssm_scan_chunked(tb[0], ta, tb[1], tb[2])
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    _close(hf.cpu(), h_p.cpu(), tol=1e-3)
    np.testing.assert_allclose(y.float().cpu().numpy(), y_p.float().cpu().numpy(),
                               rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# The kernel's three passes (local states, chunk scan, outputs) in plain
# PyTorch, and what surrounds the chunk-parallel kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_channel", [False, True], ids=["mamba2", "rwkv6"])
@pytest.mark.parametrize("b,s,h,n,p,chunk", SHAPES)
def test_three_pass_matches_jax(jx, per_channel, b, s, h, n, p, chunk):
    arrays = case(b, s, h, n, p, per_channel, seed=s * 7 + n)
    y_ref, h_ref = jx.ref.ssm_scan_ref(*[jx.jnp.asarray(a) for a in arrays])
    y, hf = tref.ssm_scan_three_pass(*_t(arrays), chunk=chunk)
    assert y.dtype == torch.float32 and hf.shape == (b, h, n, p)
    _close(y, y_ref)
    _close(hf, h_ref)


def test_three_pass_strong_decay(jx):
    arrays = strong_decay_case()
    y_ref, h_ref = jx.ref.ssm_scan_ref(*[jx.jnp.asarray(a) for a in arrays])
    y, hf = tref.ssm_scan_three_pass(*_t(arrays), chunk=16)
    assert torch.isfinite(y).all()
    _close(y, y_ref)
    _close(hf, h_ref)


@pytest.mark.parametrize("s,chunk,per_channel,seed", SWEEP)
def test_three_pass_chunk_invariance(jx, s, chunk, per_channel, seed):
    arrays = case(1, s, 2, 4, 8, per_channel, seed)
    y_ref, h_ref = jx.ref.ssm_scan_ref(*[jx.jnp.asarray(a) for a in arrays])
    y, hf = tref.ssm_scan_three_pass(*_t(arrays), chunk=chunk)
    _close(y, y_ref, tol=3e-4)
    _close(hf, h_ref, tol=3e-4)


def test_three_pass_initial_state_and_bf16(jx):
    """h0 carries into the first chunk; bf16 x/b/c give bf16 y within one
    rounding of JAX's chunked form and fp32 h_final within 2e-4."""
    arrays = case(1, 20, 2, 4, 8, True, seed=3)
    h0 = np.random.default_rng(4).normal(0, 1, (1, 2, 4, 8)).astype(np.float32)
    y_ref, h_ref = jx.ref.ssm_scan_ref(*[jx.jnp.asarray(a) for a in (*arrays, h0)])
    y, hf = tref.ssm_scan_three_pass(*_t(arrays), torch.from_numpy(h0), chunk=8)
    _close(y, y_ref)
    _close(hf, h_ref)
    jnp = jx.jnp
    x, a, bb, c = case(1, 40, 2, 8, 8, False, seed=9)
    jb = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, bb, c)]
    y_j, h_j = jx.ref.ssm_scan_xla(jb[0], jnp.asarray(a), jb[1], jb[2], chunk=16)
    tb = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, bb, c)]
    y_t, h_t = tref.ssm_scan_three_pass(tb[0], torch.from_numpy(a), tb[1], tb[2], chunk=16)
    assert y_t.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    _close(h_t, h_j)
    np.testing.assert_allclose(
        y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32)), rtol=8e-3, atol=8e-3
    )


@pytest.mark.parametrize("shape,chunk,per_head,state,decay,nbytes", [
    ((1, 4096, 80, 64, 64), 64, True, (1, 80, 64, 64, 64), (1, 80, 64, 1), 83_886_080),
    ((1, 1024, 32, 64, 64), 64, False, (1, 32, 16, 64, 64), (1, 32, 16, 64), 8_388_608),
    ((2, 33, 3, 8, 4), 16, True, (2, 3, 3, 8, 4), (2, 3, 3, 1), 2_304),
    ((1, 9, 1, 4, 8), 16, False, (1, 1, 1, 4, 8), (1, 1, 1, 4), 128),
])
def test_scratch_shapes(shape, chunk, per_head, state, decay, nbytes):
    """The wrapper's fp32 scratch: a state per (batch, head, chunk), 84 MB
    at Zamba2's prefill, and a decay per chunk (one a head for Mamba2)."""
    got_state, got_decay = tkernel.scratch_shapes(*shape, chunk, per_head)
    assert got_state == state and got_decay == decay
    assert 4 * int(np.prod(got_state)) == nbytes


@pytest.mark.parametrize("n,p,chunk,per_head,smem,blocks", [
    (64, 64, 64, True, (33_040, 68_880), (6, 3)),
    (64, 64, 64, False, (50_176, 86_016), (4, 2)),
    (4, 4, 8, False, (448, 1_088), (8, 8)),
    (8, 16, 33, True, (3_328, 10_112), (8, 8)),
])
def test_shared_memory_and_blocks_an_sm(n, p, chunk, per_head, smem, blocks):
    """Each pass's shared memory (the source's state_smem/output_smem) and
    the blocks of 256 threads that fit an H100 SM by it: three of the
    Mamba2 output pass, two of the RWKV-6 one."""
    got = tkernel.shared_memory_bytes(n, p, chunk, per_head)
    assert got == smem
    assert tuple(tkernel.blocks_per_sm(b) for b in got) == blocks
    assert max(got) <= tkernel.BLOCK_SHARED_LIMIT


def test_largest_state_is_refused_before_launch():
    """N = P = 256 with 64-token chunks needs more shared memory than a
    block may take; the launch refuses it before any pass runs
    (cudaFuncSetAttribute), and the wrapper raises."""
    assert max(tkernel.shared_memory_bytes(256, 256, 64, False)) > tkernel.BLOCK_SHARED_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("per_channel", [False, True], ids=["mamba2", "rwkv6"])
def test_cuda_kernel_matches_three_pass(card, per_channel):
    """The reference's cases on the chunk-parallel kernel against its plain
    three-pass version, at the reference's bars."""
    cases = [(case(b, s, h, n, p, per_channel, seed=s * 7 + n), chunk, 2e-4)
             for b, s, h, n, p, chunk in SHAPES]
    cases += [(case(1, s, 2, 4, 8, per_channel, seed), chunk, 3e-4) for s, chunk, _, seed in SWEEP]
    cases.append((strong_decay_case(), 16, 2e-4))
    for arrays, chunk, tol in cases:
        t = [v.to(card) for v in _t(arrays)]
        y, hf = tkernel.ssm_scan_cuda(*t, chunk=chunk)
        y3, h3 = tref.ssm_scan_three_pass(*t, chunk=chunk)
        _close(y.cpu(), y3.cpu(), tol=tol)
        _close(hf.cpu(), h3.cpu(), tol=tol)


@pytest.mark.gpu
def test_cuda_largest_state_raises(card):
    """The case above on the card: the launch's error is raised."""
    x = torch.zeros(1, 64, 1, 256, device=card)
    bc = torch.zeros(1, 64, 1, 256, device=card)
    a = torch.ones(1, 64, 1, 256, device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        tkernel.ssm_scan_cuda(x, a, bc, bc)


@pytest.mark.gpu
def test_shared_memory_formulas_match_the_source(card):
    """The Python formulas (used by the CPU tests) against the numbers the
    built source computes and asks the launches for."""
    lib = tkernel.build().lib
    for n, p, chunk in ((64, 64, 64), (4, 4, 8), (8, 16, 33), (16, 32, 48), (256, 256, 64)):
        for per_head in (True, False):
            want = tkernel.shared_memory_bytes(n, p, chunk, per_head)
            got = tuple(lib.ssm_scan_smem(n, p, chunk, int(per_head), pas) for pas in (0, 1))
            assert got == want, (n, p, chunk, per_head)


@pytest.mark.gpu
def test_cuda_kernel_strided_per_head(card):
    """Mamba2's layout: x a view of a wider projection, c one row broadcast
    over the heads (stride 0), a (B, S, H); bf16."""
    rng = np.random.default_rng(2)
    proj = torch.from_numpy(rng.normal(0, 1, (1, 300, 6, 48)).astype(np.float32))
    x = proj.to(card, torch.bfloat16)[..., :32]
    bb = torch.from_numpy(rng.normal(0, 0.5, (1, 300, 6, 16)).astype(np.float32)).to(card).bfloat16()
    c = torch.from_numpy(rng.normal(0, 0.5, (1, 300, 1, 16)).astype(np.float32)).to(card)
    c = c.bfloat16().expand(1, 300, 6, 16)
    a = torch.from_numpy(np.exp(-np.exp(rng.normal(-1.0, 0.7, (1, 300, 6)))).astype(np.float32))
    y, hf = tkernel.ssm_scan_cuda(x, a.to(card), bb, c)
    y3, h3 = tref.ssm_scan_three_pass(x, a.to(card), bb, c)
    _close(hf.cpu(), h3.cpu(), tol=2e-4)
    np.testing.assert_allclose(y.float().cpu().numpy(), y3.float().cpu().numpy(),
                               rtol=2 ** -7, atol=1e-3)
