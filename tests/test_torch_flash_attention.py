"""The port's attention against the JAX package's, at the TPU kernel's own
bar (2e-5; 3e-5 for the property cases): the plain versions
``attention_ref`` and ``flash_attention_blocked`` against JAX's
``attention_ref`` and the Pallas kernel in interpret mode on the cases of
tests/test_kernel_flash_attention.py, the device dispatch, and (on a card
only) the CUDA kernel against its plain versions in fp32 and bf16."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tkernel, ops as tops, ref as tref

# (b, s, h, kv, d, block_q, block_k): causal, GQA 2:1, MQA with a seq
# length that is no power of two, and a padded last block
CAUSAL = [
    (1, 64, 2, 2, 32, 16, 16),
    (2, 128, 4, 2, 32, 32, 64),
    (1, 96, 4, 1, 16, 32, 32),
    (1, 80, 2, 2, 64, 32, 32),
]
WINDOWS = [8, 32, 100]
# (s, h, window, seed): fixed draws from the property test's ranges
PROPERTY = [(8, 1, None, 0), (17, 2, 4, 11), (33, 4, 64, 5), (50, 1, 16, 100),
            (64, 2, None, 7), (80, 4, 9, 99), (23, 2, 23, 42), (71, 1, 5, 3)]


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only tests run where jax
    is not installed."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.ref import attention_ref

    return SimpleNamespace(jnp=jnp, ref=attention_ref, pallas=flash_attention_pallas)


def qkv(b, sq, sk, h, kv, d, seed):
    """The inputs of tests/test_kernel_flash_attention.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, sq, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, sk, kv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, kv, d)).astype(np.float32)
    return q, k, v


def _t(arrays, device="cpu", dtype=torch.float32):
    return [torch.from_numpy(a).to(device, dtype) for a in arrays]


def _np(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _against_jax(jx, arrays, tol, *, window=None, q_offset=0, block_q, block_k):
    """Both plain versions against JAX's oracle and its Pallas kernel."""
    j = [jx.jnp.asarray(a) for a in arrays]
    ref = jx.ref(*j, causal=True, window=window)
    pallas = jx.pallas(*j, causal=True, window=window, q_offset=q_offset,
                       block_q=block_q, block_k=block_k, interpret=True)
    t = _t(arrays)
    blocked = tref.flash_attention_blocked(*t, causal=True, window=window, q_offset=q_offset,
                                           block_q=block_q, block_k=block_k)
    assert blocked.dtype == torch.float32 and tuple(blocked.shape) == ref.shape
    _close(blocked, pallas, tol)
    _close(blocked, ref, tol)
    _close(tref.attention_ref(*t, causal=True, window=window), ref, tol)


@pytest.mark.parametrize("b,s,h,kv,d,bq,bk", CAUSAL)
def test_causal_matches_jax(jx, b, s, h, kv, d, bq, bk):
    _against_jax(jx, qkv(b, s, s, h, kv, d, seed=s + h), 2e-5, block_q=bq, block_k=bk)


@pytest.mark.parametrize("window", WINDOWS)
def test_sliding_window_matches_jax(jx, window):
    _against_jax(jx, qkv(1, 96, 96, 2, 2, 32, seed=window), 2e-5, window=window,
                 block_q=32, block_k=32)


def test_q_offset_matches_jax(jx):
    """16 queries at the end of 64 keys: the oracle aligns them at
    sk - sq, the blocked version and the kernel take q_offset = 48."""
    _against_jax(jx, qkv(1, 16, 64, 2, 2, 16, seed=9), 2e-5, q_offset=48,
                 block_q=16, block_k=16)


@pytest.mark.parametrize("s,h,window,seed", PROPERTY)
def test_property_cases_match_jax(jx, s, h, window, seed):
    _against_jax(jx, qkv(1, s, s, h, h, 16, seed=seed), 3e-5, window=window,
                 block_q=16, block_k=16)


@pytest.mark.parametrize("bq,bk", [(16, 16), (16, 64), (64, 16), (128, 128)])
def test_blocked_does_not_depend_on_block_size(bq, bk):
    t = _t(qkv(2, 72, 72, 4, 2, 32, seed=1))
    want = tref.attention_ref(*t, window=20)
    _close(tref.flash_attention_blocked(*t, window=20, block_q=bq, block_k=bk), want)


def test_rows_with_no_key_are_zero():
    """40 queries aligned at the end of 24 keys: the first 16 rows precede
    every key. The oracle gives them 0, and so does the blocked version,
    whatever its blocks (the kernel's arithmetic)."""
    t = _t(qkv(1, 40, 24, 2, 2, 16, seed=3))
    want = tref.attention_ref(*t)
    assert torch.equal(want[:, :16], torch.zeros_like(want[:, :16]))
    for bq, bk in ((16, 16), (8, 32)):
        got = tref.flash_attention_blocked(*t, q_offset=-16, block_q=bq, block_k=bk)
        assert torch.equal(got[:, :16], want[:, :16])
        _close(got, want)


def test_bf16_oracle_matches_jax(jx):
    """bf16 inputs: the logits' einsum and the scale round to bf16 as in
    JAX's oracle; the result is within one bf16 rounding."""
    jnp = jx.jnp
    arrays = qkv(1, 48, 48, 4, 2, 32, seed=2)
    want = jx.ref(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], window=16)
    got = tref.attention_ref(*_t(arrays, dtype=torch.bfloat16), window=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -8)


def test_dispatch_sends_cpu_tensors_to_the_oracle():
    t = _t(qkv(1, 40, 40, 4, 2, 16, seed=4))
    before = tkernel.LAUNCHES.value
    got = tops.flash_attention(*t, window=12)
    assert tkernel.LAUNCHES.value == before
    assert torch.equal(got, tref.attention_ref(*t, window=12))
    assert torch.equal(tops.flash_attention(*t, use_kernel=False), tref.attention_ref(*t))


def test_dispatch_refuses_kernel_on_cpu():
    with pytest.raises(ValueError):
        tops.flash_attention(*_t(qkv(1, 8, 8, 1, 1, 16, seed=0)), use_kernel=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        tkernel.flash_attention_cuda(*_t(qkv(1, 8, 8, 1, 1, 16, seed=0)))


def test_shared_memory_fits_two_blocks_an_sm():
    """At Zamba2's head dim 80 a block takes 78,848 bytes (the kernel
    source's figure): two fit the 228 KB of an H100 SM, one fits up to the
    largest head dim."""
    assert tkernel.shared_memory_bytes(80) == 78_848
    assert 2 * tkernel.shared_memory_bytes(80) <= 227 * 1024
    assert tkernel.shared_memory_bytes(tkernel.MAX_HEAD_DIM) <= 227 * 1024


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _card_cases():
    """(name, arrays, window, q_offset) over every case above."""
    cases = [(f"causal {c}", qkv(c[0], c[1], c[1], *c[2:5], seed=c[1] + c[2]), None, 0)
             for c in CAUSAL]
    cases += [(f"window {w}", qkv(1, 96, 96, 2, 2, 32, seed=w), w, 0) for w in WINDOWS]
    cases.append(("q_offset", qkv(1, 16, 64, 2, 2, 16, seed=9), None, 48))
    cases.append(("no key", qkv(1, 40, 24, 2, 2, 16, seed=3), None, -16))
    cases += [(f"property {p}", qkv(1, p[0], p[0], p[1], p[1], 16, seed=p[3]), p[2], 0)
              for p in PROPERTY]
    cases.append(("head dim 80", qkv(2, 130, 130, 4, 2, 80, seed=8), 50, 0))
    return cases


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_fp32(card):
    """At the TPU kernel's 2e-5 on every case, the property cases too."""
    for name, arrays, window, q_offset in _card_cases():
        t = _t(arrays, card)
        before = tkernel.LAUNCHES.value
        got = tkernel.flash_attention_cuda(*t, window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES.value == before + 1, name
        assert got.dtype == torch.float32 and got.shape == t[0].shape, name
        _close(got, tref.flash_attention_blocked(*t, window=window, q_offset=q_offset))
        sq, sk = t[0].shape[1], t[1].shape[1]
        if q_offset == sk - sq:  # where the oracle's alignment is the kernel's
            _close(got, tref.attention_ref(*t, window=window))


@pytest.mark.gpu
def test_cuda_kernel_bf16(card):
    """bf16 in and out, fp32 inside: within one bf16 rounding of the
    blocked version on the same bf16 inputs."""
    t = _t(qkv(1, 300, 300, 8, 4, 80, seed=6), card, torch.bfloat16)
    got = tkernel.flash_attention_cuda(*t)
    want = tref.flash_attention_blocked(*t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -9)


@pytest.mark.gpu
def test_cuda_strided_inputs(card):
    """q, k and v read in place from one fused (B, S, 3, H, D) projection."""
    fused = torch.randn(1, 70, 3, 4, 32, generator=torch.Generator().manual_seed(0)).to(card)
    q, k, v = fused.unbind(2)
    _close(tkernel.flash_attention_cuda(q, k, v), tref.attention_ref(q, k, v))
