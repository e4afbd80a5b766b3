"""The port's Zyphra Zamba2 (``configs/zamba2_7b.py``, ``models/zamba2.py``)
against the plain float32 reference (``tests/zamba2_reference.py``) on the
CPU, at a small size on seeded weights: 8 layers, two shared blocks taken
in turn over three hybrid ids, adapters of rank 8, two SSM groups, the
concatenated embedding. The JAX package has no such model, so nothing here
imports JAX.

Tolerance, and why: the port computes in bf16 (weights, activations, the
hidden stream) with fp32 sums, the reference in fp32 on the same (bf16)
weights. Each module is within a few bf16 roundings (a Mamba2 layer about
0.5%, a shared block about 1%: test_modules_within_bf16_roundings), and
the eight layers of random weights amplify that to 4-5% of the logits in
norm. Logits are held to ``REL_TOL`` = 0.15 relative in norm, three times
that. The same reference computed with every matrix product's inputs in
float8 e4m3 (one precision below bf16) lands 45-50% away, and each
mechanism taken out of the port's parameters (one block for both, no
adapter, no embedding in the block's input, one SSM group) 2-5 times the
logits' norm away: each fails the tolerance.
"""

import copy
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import trace
from repro_torch.configs import zamba2_7b
from repro_torch.core import sa_serve as tserve
from repro_torch.models import decoder, init_cache, init_params, prefill
from repro_torch.models import attention as tattn, ssm as tssm, zamba2 as tz

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import zamba2_reference as ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL_TOL = 0.15
SMALL = dict(zamba2_7b.PUBLISHED, hidden_size=64, attention_hidden_size=128,
             num_attention_heads=4, num_key_value_heads=4, attention_head_dim=32,
             ffn_hidden_size=128, vocab_size=256, mamba_d_state=16, mamba_headdim=16,
             n_mamba_heads=8, num_hidden_layers=8, hybrid_layer_ids=[1, 4, 6], adapter_rank=8)
PROMPT, STEPS = 70, 4  # 70 positions: two scan chunks, the second ragged


@pytest.fixture(scope="module")
def cfg():
    return zamba2_7b.from_hf(SMALL)


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, 3, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, PROMPT + STEPS)))


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _port_last(cfg, params, tokens):
    return prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, max_len=PROMPT + STEPS)[0]


def _ref_last(params, tokens, precision="float32"):
    return torch.stack([ref.logits(SMALL, params, tokens[b, :PROMPT], 1, precision)[0]
                        for b in range(tokens.shape[0])])


@pytest.fixture(scope="module")
def want(params, tokens):
    return _ref_last(params, tokens)


# -- the configuration --------------------------------------------------------


def test_published_config():
    cfg = tconfigs.get_config("zamba2-7b")
    assert cfg is zamba2_7b.CONFIG and cfg.family == "zamba2"
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_ngroups, cfg.ssm_conv_dim) == (81, 3584, 112, 64, 64, 2, 7424)
    assert (cfg.num_heads, cfg.head_dim, cfg.attn_width, cfg.d_ff, cfg.adapter_rank,
            cfg.num_mem_blocks, cfg.padded_vocab) == (32, 224, 7168, 14336, 128, 2, 32000)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)
    assert cfg.layer_kinds().count("mamba+attn") == 13
    assert cfg.attn_scale == pytest.approx(112 ** -0.5)
    # 114.7 M tied embedding, 81 × 78.4 M Mamba2, 2 × 334.0 M blocks, 13 × 17.0 M uses
    assert cfg.param_count() == 7_356_749_648
    meta = init_params(cfg, 0, device="meta")
    assert sum(t.numel() for t in _leaves(meta)) == cfg.param_count()
    assert sum(t.numel() * t.element_size() for t in _leaves(meta)) == 14_716_548_416
    cache = init_cache(cfg, 8, 3648, device="meta")
    assert sum(t.numel() * t.element_size() for t in _leaves(cache)) == 12_095_877_120


def test_port_archs_stay_beside_the_jax_list():
    assert "zamba2_7b" in tconfigs.PORT_ARCH_IDS and "zamba2_7b" not in tconfigs.ARCH_IDS


@pytest.mark.parametrize("key,value", [("hidden_act", "silu"), ("use_conv_bias", False),
                                       ("use_shared_attention_adapter", True),
                                       ("num_key_value_heads", 8), ("attention_head_dim", 112)])
def test_from_hf_refuses_what_the_port_does_not_implement(key, value):
    with pytest.raises(ValueError):
        zamba2_7b.from_hf(dict(zamba2_7b.PUBLISHED, **{key: value}))


def test_small_config_keeps_every_mechanism(cfg):
    assert cfg.num_mem_blocks == 2 and len(cfg.hybrid_layer_ids) >= 3
    assert cfg.adapter_rank > 0 and cfg.ssm_ngroups == 2 and cfg.attn_width == 2 * cfg.d_model
    assert tconfigs.reduced_config(zamba2_7b.CONFIG).ssm_ngroups == 2


def test_init_draws(params, cfg):
    for name in ("adapter_a", "adapter_b", "linear"):
        assert (params["uses"][name] != 0).all(), name
    dt = torch.nn.functional.softplus(params["mamba"]["dt_bias"])
    assert float(dt.min()) >= tz.DT_MIN * 0.999 and float(dt.max()) <= tz.DT_MAX * 1.001
    assert params["embed"].dtype == torch.bfloat16 and params["mamba"]["conv_b"].dtype == torch.float32
    again = init_params(cfg, 3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(params), _leaves(again)))


def _leaves(tree):
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


# -- the port against the reference ------------------------------------------


def test_modules_within_bf16_roundings(cfg, params):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (1, PROMPT, cfg.d_model)).astype(np.float32))
    x = x.to(torch.bfloat16)
    p = {k: v[0] for k, v in params["mamba"].items()}
    got = tssm.mamba2_grouped_block(x, p, cfg)[0]
    want = ref._mamba(x[0].float(), {k: v.float() for k, v in p.items()}, SMALL, "float32")
    assert _rel(got, want) < 0.02
    bp = {k: v[1] for k, v in params["blocks"].items()}
    up = {k: v[1] for k, v in params["uses"].items()}
    x_emb = (x.float() * 0.05).to(torch.bfloat16)
    q, k, v = tz._qkv(x, x_emb, bp, cfg, torch.arange(PROMPT)[None])
    o = tattn.blocked_attention(q, k, v, window=PROMPT, scale=cfg.attn_scale)
    got = tz._mlp(o, bp, up, cfg)[0]
    want = ref._shared(x[0].float(), x_emb[0].float(), {k: v.float() for k, v in bp.items()},
                       {k: v.float() for k, v in up.items()}, SMALL, "float32")
    assert _rel(got, want) < 0.03


def test_prefill_logits_match_the_reference(cfg, params, tokens, want):
    got = _port_last(cfg, params, tokens)
    assert got.shape == want.shape == (2, cfg.padded_vocab)
    assert _rel(got, want) < REL_TOL


def test_decode_through_the_cache_matches_the_full_forward(cfg, params, tokens):
    """Prefill the prompt, then decode the next STEPS - 1 tokens through a
    decoder, teacher-forced: each step's logits against the reference's full
    forward over the prompt and the tokens so far."""
    logits, cache, n = prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, max_len=PROMPT + STEPS)
    before = {k: v.clone() for k, v in cache.items() if k != "mamba"}
    dec = decoder(cfg, params, cache)
    got, written = [logits], []
    for i in range(STEPS - 1):
        got.append(dec.step({"tokens": tokens[:, n + i:n + i + 1]}, n + i))
        written.append(dec.last)
    for b in range(tokens.shape[0]):
        want = ref.logits(SMALL, params, tokens[b, :PROMPT + STEPS - 1], STEPS)
        assert _rel(torch.stack([g[b].clone() for g in got]), want) < REL_TOL, b
    # the first step wrote into a copy: the prompt's cache is shared; the
    # steps take the decoder's two sets of buffers in turn
    first = prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, max_len=PROMPT + STEPS)[1]
    assert all(torch.equal(first[k], before[k]) for k in before)
    assert isinstance(dec, tz.Decoder) and written == [0, 1, 0]
    assert len(dec.sets) == 2 and dec.sets[0]["k"] is not dec.sets[1]["k"]
    assert all(s["k"] is not cache["k"] for s in dec.sets)


def test_the_float8_control_fails_the_tolerance(params, tokens, want):
    assert _rel(_ref_last(params, tokens, "float8_e4m3"), want) > REL_TOL


def _one_block(p):
    p["blocks"] = {k: torch.stack([v[0]] * v.shape[0]) for k, v in p["blocks"].items()}


def _no_adapter(p):
    p["uses"]["adapter_b"].zero_()


def _no_concat(p):
    d = p["embed"].shape[1]
    for k in ("wq", "wk", "wv"):
        p["blocks"][k][:, d:] = 0  # the rows that read the embedding's half


def _one_group(p):
    """Group 1's B and C (in_proj columns, conv taps, conv bias) made group
    0's: every head then reads group 0's."""
    d_in, n = 2 * SMALL["hidden_size"], SMALL["mamba_d_state"]
    for base in (d_in, d_in + 2 * n):  # B, then C, in the conv's channels
        for name, off in (("in_proj", d_in), ("conv_w", 0), ("conv_b", 0)):
            t = p["mamba"][name]
            t[..., off + base + n:off + base + 2 * n] = t[..., off + base:off + base + n]


@pytest.mark.parametrize("mutate", [_one_block, _no_adapter, _no_concat, _one_group],
                         ids=["one_block", "no_adapter", "no_concat", "one_group"])
def test_each_mechanism_removed_fails_the_tolerance(cfg, params, tokens, want, mutate):
    broken = copy.deepcopy(params)
    mutate(broken)
    assert _rel(_port_last(cfg, broken, tokens), want) > REL_TOL


def test_the_card_route_hands_the_kernels_their_shapes(cfg, params, tokens, monkeypatch):
    """Prefill down the card's path, each kernel's plain version in its
    place: the attention kernel gets bf16 q, k and v laid out for TMA with
    the model's scale, the scan 8 heads (two groups' B and C copied to their
    heads); the logits stay within the bf16 rounding of the CPU path's."""
    from repro_torch.kernels import flash_attention as tfa, ops as kops, ref as kref

    want = _port_last(cfg, params, tokens)
    attn, scans = [], []

    def attention(q, k, v, **kw):
        assert all(tfa.tma_layout_error(t) is None for t in (q, k, v))
        attn.append((q.shape[-1], kw["scale"], kw["causal"], kw["window"]))
        return kref.flash_attention_blocked(q, k, v, **kw)

    def scan(x, a, b, c, chunk):
        scans.append((x.shape[2], a.dim(), b.shape, c.shape))
        return kref.ssm_scan_chunked(x, a, b, c, chunk=chunk)

    monkeypatch.setattr(kops, "_on_card", lambda t, use_kernel: True)
    monkeypatch.setattr(tattn, "flash_attention_cuda", attention)
    monkeypatch.setattr(kops.ssm_scan_kernel, "ssm_scan_cuda", scan)
    got = _port_last(cfg, params, tokens)
    assert attn == [(32, cfg.attn_scale, True, None)] * len(cfg.hybrid_layer_ids)
    assert scans == [(8, 3, (2, PROMPT, 8, 16), (2, PROMPT, 8, 16))] * cfg.num_layers
    assert _rel(got, want) < 0.02


# -- the serve study -----------------------------------------------------------


def test_serve_study_returns_ids_and_confidences_with_its_spans(cfg, params, tokens):
    prompts = {p: tokens[:, :16].roll(p, 1).numpy() for p in range(2)}
    sets = [tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": 40, "threshold": th}.items()))
            for p in range(2) for rp in (1.0, 1.2) for th in (0.3, 0.6)]
    with trace.recording():
        out = tserve.run_sa_serve(cfg, params, prompts, sets, gen_len=3, max_len=20,
                                  hbm_budget_bytes=None)
    spans = trace.records()
    assert out["tasks_executed"] == 2 + 4 + 8
    for rid, ps in enumerate(sets):
        ids, conf = out["ids"][rid], out["conf"][rid]
        assert ids.shape == conf.shape == (2, 3)
        assert out["accept_rate"][rid] == float((conf > dict(ps)["threshold"]).float().mean())
    by = {}
    for sp in spans:
        by.setdefault(sp.name, []).append(sp)
    assert [sp.attrs for sp in by["study"]] == [{"runs": 8}]
    assert [sp.attrs for sp in by["serve.prefill"]] == [{"tokens": 32, "batch": 2}] * 2
    assert [sp.attrs for sp in by["serve.generate"]] == [{"steps": 3}] * 4
    assert [sp.attrs for sp in by["serve.decode_step"]] == [{}] * 12
    assert all(sp.layer == "serve" for name in by for sp in by[name] if name.startswith("serve"))


def test_training_forward_refuses():
    from repro_torch.models import forward_train

    with pytest.raises(NotImplementedError):
        forward_train(zamba2_7b.from_hf(SMALL), {}, {"tokens": torch.zeros(1, 2)})


# -- the reference -------------------------------------------------------------


def test_the_reference_is_the_benchmarks_copy_and_imports_no_program():
    import ast

    text = (ROOT / "tests" / "zamba2_reference.py").read_text()
    assert text == (ROOT / "perfbench" / "reference" / "zamba2.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "torch"}


def test_reference_scan_is_the_recurrence():
    """The reference's chunked scan against the recurrence stepped token by
    token in float64, at 70 positions (a ragged second chunk)."""
    rng = np.random.default_rng(9)
    s, h, p, n = 70, 3, 4, 5
    x, b, c = (torch.from_numpy(rng.normal(0, 1, shape)) for shape in
               ((s, h, p), (s, h, n), (s, h, n)))
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, (s, h)))
    a = -torch.from_numpy(rng.uniform(0.5, 3.0, (h,)))
    state, ys = torch.zeros(h, n, p, dtype=torch.float64), []
    for t in range(s):
        state = torch.exp(dt[t] * a)[:, None, None] * state + (dt[t, :, None] * b[t])[..., None] * x[t, :, None, :]
        ys.append(torch.einsum("hnp,hn->hp", state, c[t]))
    torch.testing.assert_close(ref._scan(x, dt, a, b, c), torch.stack(ys), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_attention_scale(scale):
    """A passed scale multiplies fp32 logits (prefill and decode agree with
    the dense oracle); None keeps JAX's q rounded in its dtype."""
    from repro_torch.kernels import ref as kref

    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 9, 2, 32)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got = tattn.blocked_attention(q, k, v, window=9, scale=scale)
    want = kref.attention_ref(q.float(), k.float(), v.float(), causal=True, scale=scale)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    dec = tattn.decode_attention(q[:, -1:], k, v, 9, window=2**30, scale=scale)
    torch.testing.assert_close(dec.float(), got[:, -1:].float(), rtol=2e-2, atol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_prefill_and_decode_at_published_widths(card):
    """Eight layers at the published widths (three uses of the two blocks,
    112 Mamba2 heads in two groups, attention at head dim 224) on the card:
    prefill runs the scan kernel in every layer and the tensor-core
    attention at every use, and prefill and decode through a decoder (its
    steps replayed as CUDA graphs) are within the tolerance of the float32
    reference; the float8 control is not."""
    from repro_torch.kernels import flash_attention as tfa, ssm_scan as tss

    pub = dict(zamba2_7b.PUBLISHED, num_hidden_layers=8, hybrid_layer_ids=[1, 4, 6])
    cfg = zamba2_7b.from_hf(pub)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(7), device=card)
    gen = torch.Generator(device=card).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (2, 515), generator=gen, device=card)
    fa0, ss0 = tfa.WGMMA_LAUNCHES.value, tss.LAUNCHES.value
    logits, cache, n = prefill(cfg, params, {"tokens": toks[:, :512]}, max_len=516)
    assert (tfa.WGMMA_LAUNCHES.value - fa0, tss.LAUNCHES.value - ss0) == (3, 8)
    dec = decoder(cfg, params, cache)
    got = [logits] + [dec.step({"tokens": toks[:, n + i:n + i + 1]}, n + i) for i in range(3)]
    for b in range(2):
        want = ref.logits(pub, params, toks[b, :515], 4)
        assert _rel(torch.stack([g[b] for g in got]), want) < REL_TOL, b
        low = ref.logits(pub, params, toks[b, :515], 4, "float8_e4m3")
        assert _rel(low, want) > REL_TOL, b
