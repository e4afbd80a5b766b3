"""The port's attention against the JAX package's, at the TPU kernel's own
bar (2e-5; 3e-5 for the property cases): the plain versions
``attention_ref`` and ``flash_attention_blocked`` against JAX's
``attention_ref`` and the Pallas kernel in interpret mode on the cases of
tests/test_kernel_flash_attention.py, the device dispatch, the prefix-LM
mask (PaliGemma's image prefix, which the JAX model computes in its plain
``blocked_attention``) in both plain versions, and (on a card only) the CUDA
kernels against their plain versions in fp32 and bf16."""

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
# prefix-LM: none, one key, a tile of the CUDA-core kernel, most of the keys
PREFIX = [0, 1, 64, 200]


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


@pytest.mark.parametrize("prefix_len", PREFIX)
@pytest.mark.parametrize("d", [64, 256])
def test_prefix_blocked_matches_oracle(prefix_len, d):
    """The prefix-LM mask in both plain versions, causal and with a window
    that cuts into the prefix: the blocked version (the CUDA-core kernel's
    fp32 arithmetic, 64-query and 64-key blocks) within 2e-5 of the
    oracle. Every query sees the whole prefix within its window."""
    t = _t(qkv(1, 230, 230, 4, 1, d, seed=prefix_len + d))
    for window in (None, 48):
        want = tref.attention_ref(*t, window=window, prefix_len=prefix_len)
        got = tref.flash_attention_blocked(*t, window=window, prefix_len=prefix_len,
                                           block_q=64, block_k=64)
        _close(got, want)
    if prefix_len > 1:  # the first query sees the prefix: not what causal gives it
        assert not torch.allclose(want[:, 0], tref.attention_ref(*t, window=48)[:, 0])


@pytest.mark.parametrize("prefix_len", PREFIX[1:])
def test_prefix_oracle_matches_jax_model(prefix_len):
    """The oracle's prefix-LM mask is the JAX model's (``(kpos <= qpos) |
    (kpos < prefix_len)``, then the window): against its blocked_attention
    on bf16 values, at the reference's bf16 bar of 2e-2 (JAX rounds q·scale
    and the probabilities to bf16)."""
    import jax.numpy as jnp

    from repro.models.attention import blocked_attention

    arrays = qkv(1, 230, 230, 4, 1, 32, seed=prefix_len)
    t32 = [x.float() for x in _t(arrays, dtype=torch.bfloat16)]
    for window in (230, 48):
        want = blocked_attention(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
                                 window=window, prefix_len=prefix_len, chunk=64)
        got = tref.attention_ref(*t32, window=None if window == 230 else window,
                                 prefix_len=prefix_len)
        _close(got, np.asarray(want.astype(jnp.float32)), 2e-2)


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
    largest head dim, 256 (gemma3's), at 214,016 bytes."""
    assert tkernel.shared_memory_bytes(80) == 78_848
    assert 2 * tkernel.shared_memory_bytes(80) <= 227 * 1024
    assert tkernel.MAX_HEAD_DIM == 256
    assert tkernel.shared_memory_bytes(256) == 214_016
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
    """The CUDA-core kernel on bf16 in and out, fp32 inside: within one bf16
    rounding of the blocked version's fp32 arithmetic on the same bf16
    values. D = 80 would go to the tensor cores by dispatch, so the
    CUDA-core kernel is called by name."""
    t = _t(qkv(1, 300, 300, 8, 4, 80, seed=6), card, torch.bfloat16)
    before, wgmma = tkernel.LAUNCHES.value, tkernel.WGMMA_LAUNCHES.value
    got = tkernel.flash_attention_simt(*t)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES.value == before + 1 and tkernel.WGMMA_LAUNCHES.value == wgmma
    want = tref.flash_attention_blocked(*[x.float() for x in t]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -9)


@pytest.mark.gpu
def test_cuda_kernels_take_a_scale(card):
    """Both kernels scale the logits by ``scale`` when one is given: the
    CUDA-core kernel at 2e-5 of ``attention_ref(scale=...)`` in fp32, the
    tensor-core kernel within one bf16 rounding of its blocked plain
    version with the same scale."""
    t = _t(qkv(1, 150, 150, 4, 2, 64, seed=11), card)
    got = tkernel.flash_attention_simt(*t, scale=0.1)
    _close(got, tref.attention_ref(*t, scale=0.1))
    assert float((got - tref.attention_ref(*t)).abs().max()) > 1e-3
    tb = [x.to(torch.bfloat16) for x in t]
    before = tkernel.WGMMA_LAUNCHES.value
    got = tkernel.flash_attention_wgmma(*tb, scale=0.1)
    torch.cuda.synchronize()
    assert tkernel.WGMMA_LAUNCHES.value == before + 1
    want = tref.flash_attention_blocked(*tb, scale=0.1)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -9)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [72, 24])
def test_cuda_kernel_bf16_other_head_dims(card, d):
    """bf16 with D not a multiple of 16 goes to the CUDA-core kernel by
    dispatch: within one bf16 rounding of the blocked version (its fp32
    arithmetic for such D) and within 2e-2 of the oracle."""
    t = _t(qkv(1, 300, 300, 8, 4, d, seed=d), card, torch.bfloat16)
    before, wgmma = tkernel.LAUNCHES.value, tkernel.WGMMA_LAUNCHES.value
    got = tkernel.flash_attention_cuda(*t, window=120)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES.value == before + 1 and tkernel.WGMMA_LAUNCHES.value == wgmma
    want = tref.flash_attention_blocked(*t, window=120)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -9)
    _close(got, tref.attention_ref(*[x.float() for x in t], window=120), 2e-2)


@pytest.mark.gpu
def test_shared_memory_formulas_match_the_sources(card):
    """The Python formulas (used by the CPU tests) against the numbers the
    built sources compute and ask the launch for, and the tensor-core
    kernel's key tile (where the plain version rounds P) against the
    source's, at every head dim it takes; -1 for one it does not."""
    simt, wgmma = tkernel.build().lib, tkernel.build_wgmma().lib
    for d in range(1, tkernel.MAX_HEAD_DIM + 1):
        assert simt.flash_attention_smem(d) == tkernel.shared_memory_bytes(d), d
    for d in range(16, tkernel.WGMMA_MAX_HEAD_DIM + 1, 16):
        assert wgmma.flash_attention_wgmma_smem(d) == tkernel.wgmma_shared_memory_bytes(d), d
        assert wgmma.flash_attention_wgmma_key_tile(d) == tkernel.wgmma_key_tile(d), d
    for d in (8, 72, 272):
        assert wgmma.flash_attention_wgmma_smem(d) == -1 == wgmma.flash_attention_wgmma_key_tile(d)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [160, 192, 256])
def test_cuda_kernel_head_dims_over_128(card, d):
    """Head dims above 128 (gemma3's and PaliGemma's 256): fp32 on the
    CUDA-core kernel within 2e-5 of the oracle, causal and windowed, with
    GQA; bf16 on the tensor-core kernel by dispatch (64-key tiles), within
    one bf16 rounding of the blocked version at the same key blocks and
    2e-2 of the oracle."""
    t = _t(qkv(1, 200, 200, 4, 1, d, seed=d), card)
    tb = [x.to(torch.bfloat16) for x in t]
    for window in (None, 64):
        before, wgmma = tkernel.LAUNCHES.value, tkernel.WGMMA_LAUNCHES.value
        got = tkernel.flash_attention_cuda(*t, window=window)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES.value == before + 1 and tkernel.WGMMA_LAUNCHES.value == wgmma
        _close(got, tref.attention_ref(*t, window=window))
        before, simt = tkernel.WGMMA_LAUNCHES.value, tkernel.LAUNCHES.value
        got = tkernel.flash_attention_cuda(*tb, window=window)
        torch.cuda.synchronize()
        assert tkernel.WGMMA_LAUNCHES.value == before + 1 and tkernel.LAUNCHES.value == simt
        np.testing.assert_allclose(_np(got), _np(tref.flash_attention_blocked(*tb, window=window)),
                                   rtol=2 ** -7, atol=2 ** -8)
        _close(got, tref.attention_ref(*t, window=window), 2e-2)


@pytest.mark.gpu
def test_wgmma_refuses_head_dims_over_128(card):
    """The tensor-core kernel takes D a multiple of 16 up to 256 (it took
    D up to 128 before its 64-key tiles): called by name on bf16 at D = 272
    or D = 72 it raises, and never launches."""
    for d, match in ((272, "D <= 256"), (72, "up to 256")):
        t = _t(qkv(1, 64, 64, 2, 2, d, seed=0), card, torch.bfloat16)
        before = tkernel.WGMMA_LAUNCHES.value
        with pytest.raises(ValueError, match=match):
            tkernel.flash_attention_wgmma(*t)
        assert tkernel.WGMMA_LAUNCHES.value == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 256])
def test_cuda_kernel_prefix_lm(card, d):
    """Prefix-LM attention follows the dispatch: fp32 on the CUDA-core
    kernel within 2e-5 of the oracle, causal and windowed; bf16 at D = 64
    and 256 on the tensor-core kernel, within one bf16 rounding of the
    blocked version's bf16-P arithmetic at its key blocks."""
    t = _t(qkv(1, 230, 230, 4, 1, d, seed=d), card)
    tb = [x.to(torch.bfloat16) for x in t]
    for prefix_len in PREFIX:
        for window in (None, 48):
            before, wgmma = tkernel.LAUNCHES.value, tkernel.WGMMA_LAUNCHES.value
            got = tkernel.flash_attention_cuda(*t, window=window, prefix_len=prefix_len)
            torch.cuda.synchronize()
            assert tkernel.LAUNCHES.value == before + 1 and tkernel.WGMMA_LAUNCHES.value == wgmma
            _close(got, tref.attention_ref(*t, window=window, prefix_len=prefix_len))
        before, wgmma = tkernel.LAUNCHES.value, tkernel.WGMMA_LAUNCHES.value
        got = tkernel.flash_attention_cuda(*tb, prefix_len=prefix_len)
        torch.cuda.synchronize()
        cuda_cores = not tkernel.uses_tensor_cores(torch.bfloat16, d)
        assert tkernel.LAUNCHES.value == before + cuda_cores
        assert tkernel.WGMMA_LAUNCHES.value == wgmma + (not cuda_cores)
        # each kernel's own arithmetic: fp32 P on the CUDA cores, bf16 P on the tensor cores
        want = tref.flash_attention_blocked(*([x.float() for x in tb] if cuda_cores else tb),
                                            prefix_len=prefix_len)
        np.testing.assert_allclose(_np(got), _np(want.to(torch.bfloat16)), rtol=2 ** -7,
                                   atol=2 ** -8)


@pytest.mark.gpu
def test_wgmma_refuses_prefix(card):
    """The tensor-core kernel computes the prefix-LM mask (it refused a
    prefix before): called by name with prefixes from one key to past the
    keys, causal and windowed, it launches once each and stays within one
    bf16 rounding of the blocked version, and the prefix changes the
    result."""
    t = _t(qkv(1, 230, 230, 4, 2, 64, seed=0), card, torch.bfloat16)
    got = {}
    for prefix_len in (1, 16, 200, 300):
        for window in (None, 48):
            before = tkernel.WGMMA_LAUNCHES.value
            got[prefix_len, window] = tkernel.flash_attention_wgmma(*t, window=window,
                                                                    prefix_len=prefix_len)
            torch.cuda.synchronize()
            assert tkernel.WGMMA_LAUNCHES.value == before + 1
            want = tref.flash_attention_blocked(*t, window=window, prefix_len=prefix_len)
            np.testing.assert_allclose(_np(got[prefix_len, window]), _np(want), rtol=2 ** -7,
                                       atol=2 ** -8)
    causal = tkernel.flash_attention_wgmma(*t)
    assert float((got[200, None].float() - causal.float()).abs().max()) > 1e-2


@pytest.mark.gpu
def test_head_dim_over_256_is_refused(card):
    """Above the CUDA-core kernel's 16 columns a thread the wrapper raises
    and launches nothing."""
    t = _t(qkv(1, 8, 8, 1, 1, 272, seed=0), card)
    before = tkernel.LAUNCHES.value
    with pytest.raises(ValueError, match="D <= 256"):
        tkernel.flash_attention_cuda(*t)
    assert tkernel.LAUNCHES.value == before


@pytest.mark.gpu
def test_cuda_strided_inputs(card):
    """q, k and v read in place from one fused (B, S, 3, H, D) projection."""
    fused = torch.randn(1, 70, 3, 4, 32, generator=torch.Generator().manual_seed(0)).to(card)
    q, k, v = fused.unbind(2)
    _close(tkernel.flash_attention_cuda(q, k, v), tref.attention_ref(q, k, v))


# ---------------------------------------------------------------------------
# The tensor-core path: bf16 with D a multiple of 16 up to 256
# ---------------------------------------------------------------------------

def _bf16_cases():
    """(arrays, window, q_offset) of every reference case above, each with
    queries aligned at the end of the keys."""
    cases = [(qkv(c[0], c[1], c[1], *c[2:5], seed=c[1] + c[2]), None, 0) for c in CAUSAL]
    cases += [(qkv(1, 96, 96, 2, 2, 32, seed=w), w, 0) for w in WINDOWS]
    cases.append((qkv(1, 16, 64, 2, 2, 16, seed=9), None, 48))
    cases += [(qkv(1, p[0], p[0], p[1], p[1], 16, seed=p[3]), p[2], 0) for p in PROPERTY]
    return cases


BF16_IDS = [f"causal{c[:5]}" for c in CAUSAL] + [f"window{w}" for w in WINDOWS] + ["q_offset"] + [
    f"property{p}" for p in PROPERTY]


def _bf16(arrays):
    """bf16 copies, and fp32 copies of the same bf16 values."""
    t = _t(arrays, dtype=torch.bfloat16)
    return t, [x.float() for x in t]


@pytest.mark.parametrize("case", range(len(BF16_IDS)), ids=BF16_IDS)
def test_bf16_blocked_matches_jax_model(jx, case):
    """bf16 inputs take the tensor-core arithmetic (bf16 operands, fp32
    sums, P rounded to bf16): within the reference's bf16 bar of 2e-2 of the
    JAX model's blocked_attention and of the fp32 oracle on the same bf16
    values."""
    import jax.numpy as jnp

    from repro.models.attention import blocked_attention

    arrays, window, q_offset = _bf16_cases()[case]
    t, t32 = _bf16(arrays)
    got = tref.flash_attention_blocked(*t, window=window, q_offset=q_offset)
    assert got.dtype == torch.bfloat16
    sk = arrays[1].shape[1]
    want_jax = blocked_attention(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
                                 window=window or sk + q_offset, q_offset=q_offset, chunk=16)
    _close(got, np.asarray(want_jax.astype(jnp.float32)), 2e-2)
    _close(got, jx.ref(*[jx.jnp.asarray(_np(x)) for x in t32], causal=True, window=window), 2e-2)


# (sq, h, kv, d, window, prefix_len): gemma3's and PaliGemma's head dim 256
# (causal, windowed, prefix-LM, GQA 4:1), prefix-LM at D = 64 and 144
WIDE_AND_PREFIX = [(130, 2, 1, 256, None, 0), (150, 4, 1, 256, 40, 0), (140, 4, 1, 256, None, 30),
                   (200, 4, 2, 64, None, 100), (96, 2, 1, 144, 50, 20)]


@pytest.mark.parametrize("case", WIDE_AND_PREFIX, ids=[str(c) for c in WIDE_AND_PREFIX])
def test_bf16_blocked_matches_jax_model_wide_and_prefix(case):
    """The tensor-core arithmetic at D = 256 and with a prefix: the plain
    version at its default key blocks (the kernel's key tile, 64 keys above
    D = 128) against the JAX model's blocked_attention over key chunks of
    the same size, within the reference's bf16 bar of 2e-2, and the oracle
    on the same bf16 values. A card-path q is pre-scaled in bf16 with scale
    1, as blocked_attention hands it to the kernels."""
    import jax.numpy as jnp

    from repro.models.attention import blocked_attention

    sq, h, kv, d, window, prefix_len = case
    arrays = qkv(1, sq, sq, h, kv, d, seed=d + sq + prefix_len)
    t, t32 = _bf16(arrays)
    assert tref.uses_tensor_cores(torch.bfloat16, d)
    tile = tkernel.wgmma_key_tile(d)
    want_jax = blocked_attention(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
                                 window=window or sq, prefix_len=prefix_len, chunk=tile)
    got = tref.flash_attention_blocked(*t, window=window, prefix_len=prefix_len)
    _close(got, np.asarray(want_jax.astype(jnp.float32)), 2e-2)
    _close(got, tref.attention_ref(*t32, window=window, prefix_len=prefix_len), 2e-2)
    rounded = float(torch.tensor(1 / d ** 0.5, dtype=torch.bfloat16))
    qs = (t[0].float() * rounded).to(torch.bfloat16)
    card = tref.flash_attention_blocked(qs, *t[1:], window=window, prefix_len=prefix_len,
                                        scale=1.0)
    _close(card, np.asarray(want_jax.astype(jnp.float32)), 2e-2)


def test_bf16_blocked_rounds_p_only_on_the_tensor_core_path():
    """bf16 with D = 24 takes the CUDA-core arithmetic: exactly the fp32
    computation on the same values, cast to bf16, with a prefix too. With
    D = 32, and at gemma3's and PaliGemma's D = 256 (with and without a
    prefix), the probabilities are rounded to bf16, which changes the
    result."""
    for d, tensor_cores, prefix_len in ((24, False, 0), (32, True, 0), (256, True, 0),
                                        (24, False, 20), (256, True, 20)):
        t, t32 = _bf16(qkv(1, 70, 70, 2, 1, d, seed=d))
        assert tref.uses_tensor_cores(torch.bfloat16, d) is tensor_cores
        got = tref.flash_attention_blocked(*t, window=30, prefix_len=prefix_len)
        fp32_way = tref.flash_attention_blocked(*t32, window=30,
                                                prefix_len=prefix_len).to(torch.bfloat16)
        assert torch.equal(got, fp32_way) is not tensor_cores, (d, prefix_len)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, True), (torch.bfloat16, 80, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 8, False), (torch.bfloat16, 72, False), (torch.bfloat16, 144, True),
    (torch.bfloat16, 160, True), (torch.bfloat16, 256, True), (torch.bfloat16, 272, False),
    (torch.float32, 80, False), (torch.float32, 64, False), (torch.float16, 64, False),
    (torch.float32, 256, False),
])
def test_dispatch_rule_between_the_two_kernels(dtype, d, want):
    """bf16 with D a multiple of 16 up to 256 goes to the tensor-core
    kernel, 144, 160 and gemma3's and PaliGemma's 256 included; fp32 (the
    2e-5 bar), fp16 and other head dims (72, 8) to the CUDA-core one; above
    256 (272) no kernel takes it (the wrappers refuse it on the card:
    test_head_dim_over_256_is_refused)."""
    assert tkernel.uses_tensor_cores(dtype, d) is want
    assert not want or d <= tkernel.WGMMA_MAX_HEAD_DIM
    assert tkernel.WGMMA_MAX_HEAD_DIM == tkernel.MAX_HEAD_DIM == 256
    assert d <= tkernel.MAX_HEAD_DIM or not want


def test_wgmma_shared_memory_and_blocks_an_sm():
    """At D = 80 a CTA takes 144,488 bytes (q tile 20,480, three stages of
    128-key K and V tiles 122,880, 13 barriers and 1 KB of alignment
    slack); at D = 112 the rings still have three stages, at D = 128 two;
    above 128 the key tile is 64 keys, two stages, so that D = 256 takes
    197,704 bytes (q 65,536, rings 131,072); every head dim fits one CTA of
    384 threads an SM, under the 232,448 bytes a block may have."""
    assert tkernel.wgmma_shared_memory_bytes(80) == 144_488
    assert tkernel.wgmma_shared_memory_bytes(112) == 201_832
    assert tkernel.wgmma_shared_memory_bytes(128) == 164_936
    assert tkernel.wgmma_shared_memory_bytes(256) == 197_704
    for d in range(16, 257, 16):
        assert tkernel.wgmma_shared_memory_bytes(d) <= 232_448
        assert tkernel.wgmma_key_tile(d) == (128 if d <= 128 else 64)
    # blocks an SM by shared memory (228 KB, 1 KB reserved a block): one at D = 80
    assert 233_472 // (tkernel.wgmma_shared_memory_bytes(80) + 1024) == 1
    assert tkernel.wgmma_shared_memory_bytes(128) <= 227 * 1024
    assert 2048 // tkernel.WGMMA_THREADS >= 1


def test_tma_layout_checks():
    """What the tensor-core kernel's TMA loads take: bf16, D contiguous, a
    16-byte aligned start and strides that are multiples of 8 elements. The
    wrapper raises on the rest; it makes no copy."""
    ok = torch.zeros(1, 64, 4, 80, dtype=torch.bfloat16)
    assert tkernel.tma_layout_error(ok) is None
    fused = torch.zeros(2, 64, 3, 4, 32, dtype=torch.bfloat16)  # q, k, v of one projection
    assert all(tkernel.tma_layout_error(x) is None for x in fused.unbind(2))
    assert "bfloat16" in tkernel.tma_layout_error(ok.float())
    assert "head dim stride" in tkernel.tma_layout_error(ok.transpose(1, 3))
    flat = torch.zeros(1 + 64 * 4 * 80, dtype=torch.bfloat16)
    assert "aligned" in tkernel.tma_layout_error(flat[1:].view(1, 64, 4, 80))
    padded = torch.zeros(1, 64, 4, 84, dtype=torch.bfloat16)[..., :80]
    assert "multiple of 8" in tkernel.tma_layout_error(padded)
    # a dim of length 1 is never stepped over: its stride does not matter
    assert tkernel.tma_layout_error(torch.zeros(3, 64, 4, 80, dtype=torch.bfloat16)[:1]) is None


def test_wgmma_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        tkernel.flash_attention_wgmma(*_t(qkv(1, 8, 8, 1, 1, 16, seed=0), dtype=torch.bfloat16))


@pytest.mark.gpu
def test_wgmma_kernel_matches_plain_bf16(card):
    """Every case in bf16 on the tensor-core kernel: within one bf16
    rounding of the blocked version's bf16 arithmetic, and within 2e-2 of
    the fp32 oracle on the same bf16 values."""
    for name, arrays, window, q_offset in _card_cases():
        t = _t(arrays, card, torch.bfloat16)
        before, simt = tkernel.WGMMA_LAUNCHES.value, tkernel.LAUNCHES.value
        got = tkernel.flash_attention_cuda(*t, window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        assert tkernel.WGMMA_LAUNCHES.value == before + 1 and tkernel.LAUNCHES.value == simt, name
        want = tref.flash_attention_blocked(*t, window=window, q_offset=q_offset)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -8, err_msg=name)
        sq, sk = t[0].shape[1], t[1].shape[1]
        if q_offset == sk - sq:
            _close(got, tref.attention_ref(*[x.float() for x in t], window=window), 2e-2)


@pytest.mark.gpu
def test_fp32_stays_on_the_cuda_core_kernel(card):
    t = _t(qkv(1, 64, 64, 2, 2, 32, seed=1), card)
    before, wgmma = tkernel.LAUNCHES.value, tkernel.WGMMA_LAUNCHES.value
    tkernel.flash_attention_cuda(*t)
    assert tkernel.LAUNCHES.value == before + 1 and tkernel.WGMMA_LAUNCHES.value == wgmma


@pytest.mark.gpu
def test_wgmma_strided_inputs(card):
    """q, k and v read in place by TMA from one fused (B, S, 3, H, D)
    bf16 projection."""
    fused = torch.randn(2, 150, 3, 4, 64, generator=torch.Generator().manual_seed(0))
    q, k, v = fused.to(card, torch.bfloat16).unbind(2)
    got = tkernel.flash_attention_wgmma(q, k, v, window=70)
    want = tref.flash_attention_blocked(q, k, v, window=70)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=2 ** -8)


@pytest.mark.gpu
def test_wgmma_refuses_misaligned_input(card):
    flat = torch.zeros(1 + 3 * 64 * 2 * 32, dtype=torch.bfloat16, device=card)
    q, k, v = flat[1:].view(3, 1, 64, 2, 32).unbind(0)
    with pytest.raises(ValueError, match="aligned"):
        tkernel.flash_attention_wgmma(q, k, v)
