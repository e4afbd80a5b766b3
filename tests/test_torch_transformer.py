"""The port's transformer families (``dense``, ``moe``, ``vlm``, ``audio``)
against the JAX package's on the CPU, with the JAX parameters carried over
by ``params_from_jax``: parameter and cache trees, prefill and three
teacher-forced decode steps of each reduced config that the repo ships for
them, gemma3_1b at six layers so that its sixth, global layer follows five
local ones.

Tolerances, and why (as for Zamba2, tests/test_torch_zamba2.py): the JAX
model runs op by op (``jax.disable_jit()``), which rounds every bf16
operation as the port does. Embedding, norms, projections, RoPE and
attention then agree bit for bit; the bf16 matrix products round a few
elements in a thousand to the other neighbour (their fp32 sums run in
another order), and random weights amplify that over the layers. So logits
are held to 0.05 absolute and cached keys and values to 3% relative in
norm. Logits are bf16 products cast to fp32, so two of them can tie within
one bf16 rounding: the port's argmax is JAX's wherever JAX's top two differ
by more than that rounding, and otherwise one of JAX's logits within it of
the maximum.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.models import decode_step, init_cache, init_params, params_from_jax, prefill
from repro_torch.models import model as tmodel

LOGIT_ATOL = 0.05
STATE_REL = 0.03
ARCHS = ["gemma3_1b", "granite_3_8b", "granite_moe_1b_a400m", "mixtral_8x7b", "paligemma_3b",
         "musicgen_medium"]
B, S_TEXT = 2, 24  # S_TEXT > 16, gemma3's reduced local window


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bf16_ulp(x):
    """One bf16 rounding at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def assert_same_argmax(got, want):
    """Row by row: the port's argmax is JAX's, or, where JAX's top two
    logits are within one bf16 rounding of each other, a logit of JAX's
    within that rounding of the maximum."""
    got, want = _np(got).reshape(-1, _np(got).shape[-1]), _np(want).reshape(got.shape)
    for g, w in zip(got, want):
        top = np.sort(w)[-2:]
        ulp = _bf16_ulp(top[1])
        if top[1] - top[0] > ulp:
            assert int(np.argmax(g)) == int(np.argmax(w))
        else:
            assert w[int(np.argmax(g))] >= top[1] - ulp


@contextlib.contextmanager
def _op_by_op(jax):
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", False)


def reduced(configs, arch):
    cfg = configs.reduced_config(configs.get_config(arch))
    if arch == "gemma3_1b":  # six layers: five local, then a global one
        cfg = dataclasses.replace(cfg, num_layers=6)
    return cfg


def batches(cfg, rng, jnp, s_text=S_TEXT):
    """The same prompt for both packages: ({JAX batch}, {port batch})."""
    arrays = {}
    if cfg.family == "audio":
        arrays["frame_embeds"] = rng.normal(0, 1, (B, s_text, cfg.d_model)).astype(np.float32)
    else:
        arrays["tokens"] = rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32)
    if cfg.family == "vlm":
        arrays["patch_embeds"] = rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def step_batches(cfg, rng, jnp):
    """One decode step's input for both packages."""
    if cfg.family == "audio":
        a = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
        return {"frame_embeds": jnp.asarray(a)}, {"frame_embeds": torch.from_numpy(a)}
    a = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """One arch's JAX and port parameters and both prefills (JAX op by
    op) of one prompt."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import model as jmodel

    arch = request.param
    jcfg, tcfg = reduced(jconfigs, arch), reduced(tconfigs, arch)
    jparams = jmodel.init_params(jcfg, jax.random.key(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jbatch, tbatch = batches(jcfg, np.random.default_rng(5), jnp)
    n = S_TEXT + jcfg.num_patches
    max_len = n + 4
    with _op_by_op(jax):
        jl, jc, jn = jmodel.prefill(jcfg, jparams, jbatch, max_len=max_len)
    tl, tc, tn = prefill(tcfg, tparams, tbatch, max_len=max_len)
    assert jn == tn == n
    return dict(arch=arch, jax=jax, jnp=jnp, jconfigs=jconfigs, jmodel=jmodel, jcfg=jcfg,
                tcfg=tcfg, jparams=jparams, tparams=tparams, n=n, max_len=max_len,
                prefilled=(jl, jc, tl, tc))


def test_params_from_jax_keys_shapes_dtypes(run):
    flat_j, flat_t = _flat(run["jparams"]), _flat(run["tparams"])
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
        leaf = k.rsplit(".", 1)[-1]
        want = torch.bfloat16 if leaf in tmodel.BF16_WEIGHTS else torch.float32
        assert flat_t[k].dtype == want, k
        if leaf in tmodel.BF16_WEIGHTS:
            assert v.ndim >= 2, k  # a matrix or stacked matrices, never a vector
    if run["tcfg"].num_experts:
        assert flat_t["layers.router"].dtype == torch.float32  # routed in fp32, as JAX does
    assert ("embed" in flat_t) == (run["tcfg"].family != "audio")


def test_init_params_matches_params_from_jax(run):
    a, b = _flat(init_params(run["tcfg"], 0, device="cpu")), _flat(run["tparams"])
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k


def test_init_cache_matches_jax(run):
    jax, jcfg = run["jax"], run["jcfg"]
    want = _flat(jax.eval_shape(lambda: run["jmodel"].init_cache(jcfg, B, run["max_len"])))
    got = _flat(init_cache(run["tcfg"], B, run["max_len"], device="cpu"))
    assert got.keys() == want.keys() == {"k", "v"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).endswith(str(want[k].dtype)), k
        assert not got[k].any()


def test_prefill_logits_and_cache(run):
    jl, jc, tl, tc = run["prefilled"]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    cfg = run["tcfg"]
    heads = cfg.num_codebooks if cfg.family == "audio" else 1
    assert tl.shape[-1] == heads * cfg.padded_vocab
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL)
    assert_same_argmax(tl, jl)
    assert set(tc) == set(jc) == {"k", "v"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and str(tc[k].dtype).endswith(str(jc[k].dtype))
        assert _rel(tc[k], jc[k]) < STATE_REL, k
        assert not tc[k][:, :, run["n"]:].any()  # the positions past the prompt stay zero


def test_decode_step_teacher_forced(run):
    """Three steps fed the same inputs, each package from its own prefill
    cache, JAX op by op; the port's input caches are kept."""
    jax, jnp = run["jax"], run["jnp"]
    _, jc, _, tc = run["prefilled"]
    kept = {k: v.clone() for k, v in tc.items()}
    rng = np.random.default_rng(7)
    caches = [tc]
    for i in range(3):
        jb, tb = step_batches(run["tcfg"], rng, jnp)
        cur = run["n"] + i
        with _op_by_op(jax):
            jl, jc = run["jmodel"].decode_step(run["jcfg"], run["jparams"], jb, jc,
                                               jnp.int32(cur))
        tl, tc = decode_step(run["tcfg"], run["tparams"], tb, tc, cur)
        caches.append(tc)
        assert tuple(tl.shape) == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL)
        assert_same_argmax(tl, jl)
        for k in jc:
            assert _rel(tc[k], jc[k]) < STATE_REL, (i, k)
            assert tc[k][:, :, cur].any() and not tc[k][:, :, cur + 1:].any(), (i, k)
    for k, v in run["prefilled"][3].items():
        assert torch.equal(v, kept[k]), k


def test_gemma3_windows_local_then_global():
    """The six-layer reduced gemma3 has the 5:1 pattern over the prompt:
    five layers see 16 keys, the sixth all of them; full width, 512 and
    every sixth layer global."""
    cfg = reduced(tconfigs, "gemma3_1b")
    assert cfg.layer_windows(S_TEXT) == (16,) * 5 + (S_TEXT,)
    full = tconfigs.get_config("gemma3_1b")
    windows = full.layer_windows(4096)
    assert [i for i, w in enumerate(windows) if w == 4096] == [5, 11, 17, 23]
    assert set(windows) == {512, 4096}
    assert tconfigs.get_config("mixtral_8x7b").layer_windows(4096) == (4096,) * 32


@pytest.mark.parametrize("d", [32, 80, 128])
def test_card_path_scales_q_as_jax(monkeypatch, d):
    """On the card ``blocked_attention`` hands the kernels q already
    multiplied by 1/sqrt(D) rounded to bf16, rounded once, as JAX and the
    CPU path compute it, and scale 1. The card path is taken here with the
    tensor-core kernel's blocked plain version in the kernel's place: over
    one key block its result is the CPU path's, bit for bit."""
    from repro_torch.kernels import ref as tref
    from repro_torch.models import attention as tattn

    seen = []

    def kernel(q, k, v, **kw):
        seen.append((q, kw["scale"]))
        return tref.flash_attention_blocked(q, k, v, **kw)

    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 40, 4, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = tattn.blocked_attention(q, k, v, window=40)
    monkeypatch.setattr(tattn.kops, "_on_card", lambda t, use_kernel: True)
    monkeypatch.setattr(tattn, "flash_attention_cuda", kernel)
    got = tattn.blocked_attention(q, k, v, window=40)
    rounded = float(torch.tensor(1 / d ** 0.5, dtype=torch.bfloat16))
    assert rounded != 1 / d ** 0.5
    (qs, scale), = seen
    assert scale == 1.0 and qs.dtype == torch.bfloat16
    assert torch.equal(qs, (q.float() * rounded).to(torch.bfloat16))
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["gemma3_1b", "granite_3_8b", "granite_moe_1b_a400m",
                                  "mixtral_8x7b", "paligemma_3b", "musicgen_medium"])
def test_card_path_prefill_equals_cpu_through_the_plain_versions(monkeypatch, arch):
    """The reduced prefills, their attention taken down the card's path
    with the tensor-core kernel's blocked plain version in its place (bf16,
    D = 32; PaliGemma's prefix-LM mask over its patches too, which the
    tensor-core kernel now computes): logits and caches equal the CPU
    path's bit for bit, MoE routing included."""
    from repro_torch.kernels import ref as tref
    from repro_torch.models import attention as tattn

    cfg = reduced(tconfigs, arch)
    params = init_params(cfg, 0, device="cpu")
    _, batch = batches(cfg, np.random.default_rng(3), np)
    max_len = S_TEXT + cfg.num_patches + 4
    want_logits, want_cache, _ = prefill(cfg, params, batch, max_len)
    calls = []

    def kernel(q, k, v, **kw):
        assert tref.uses_tensor_cores(q.dtype, q.shape[-1])
        calls.append((kw["scale"], kw["prefix_len"]))
        return tref.flash_attention_blocked(q, k, v, **kw)

    monkeypatch.setattr(tattn.kops, "_on_card", lambda t, use_kernel: True)
    monkeypatch.setattr(tattn, "flash_attention_cuda", kernel)
    logits, cache, _ = prefill(cfg, params, batch, max_len)
    assert calls == [(1.0, cfg.num_patches)] * cfg.num_layers
    assert torch.equal(logits, want_logits)
    for k in want_cache:
        assert torch.equal(cache[k], want_cache[k]), k


@pytest.mark.parametrize("arch", ["gemma3_1b", "granite_moe_1b_a400m", "paligemma_3b",
                                  "musicgen_medium"])
def test_full_width_cache_bytes_equal_jax(arch):
    """The full-width caches chip_smoke.py allocates, sized on the meta
    device: JAX's shapes and dtypes at 4112 positions."""
    import jax

    from repro import configs as jconfigs
    from repro.models import model as jmodel

    want = _flat(jax.eval_shape(lambda: jmodel.init_cache(jconfigs.get_config(arch), 1, 4112)))
    got = _flat(init_cache(tconfigs.get_config(arch), 1, 4112, device="meta"))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3_1b", "granite_moe_1b_a400m", "mixtral_8x7b",
                                  "paligemma_3b", "musicgen_medium"])
def test_card_reduced_model_matches_cpu(card, arch):
    """The same parameters and prompt on the card (attention on the
    kernels) and on the CPU: prefill logits within 0.05, caches within 3%,
    and one decode step's logits within 0.05."""
    from repro_torch.kernels import flash_attention as fa

    cfg = reduced(tconfigs, arch)
    cpu_params = init_params(cfg, 0, device="cpu")
    card_params = {k: ({kk: vv.to(card) for kk, vv in v.items()} if isinstance(v, dict)
                       else v.to(card)) for k, v in cpu_params.items()}
    rng = np.random.default_rng(1)
    _, batch = batches(cfg, rng, np)
    n = S_TEXT + cfg.num_patches
    before = fa.LAUNCHES.value + fa.WGMMA_LAUNCHES.value
    lc, cc, _ = prefill(cfg, card_params, {k: v.to(card) for k, v in batch.items()}, n + 4)
    assert fa.LAUNCHES.value + fa.WGMMA_LAUNCHES.value == before + cfg.num_layers
    lp, cp, _ = prefill(cfg, cpu_params, batch, n + 4)
    np.testing.assert_allclose(_np(lc.cpu()), _np(lp), rtol=0, atol=LOGIT_ATOL)
    for k in cp:
        assert _rel(cc[k].cpu(), cp[k]) < STATE_REL, k
    _, step = step_batches(cfg, rng, np)
    dc, _ = decode_step(cfg, card_params, {k: v.to(card) for k, v in step.items()}, cc, n)
    dp, _ = decode_step(cfg, cpu_params, step, cp, n)
    np.testing.assert_allclose(_np(dc.cpu()), _np(dp), rtol=0, atol=LOGIT_ATOL)
