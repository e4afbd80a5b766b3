"""The port's IBM Granite 4.0-H (``configs/granite_4_0_h_small.py``,
``models/granite_hybrid.py``, the dropless and shared-expert MoE of
``models/moe.py``) against the plain float32 reference
(``tests/granite_hybrid_reference.py``) on the CPU, at one reduced period of
the layer pattern on seeded weights: 10 layers (nine Mamba2, one attention
at index 5), width 64, 8 experts with the top 3 taken, the shared expert and
the published multipliers. The JAX package has no such model, so nothing
here imports JAX.

Tolerance, and why: the port computes in bf16 (weights, activations, the
hidden stream) with fp32 sums, the reference in fp32 on the same (bf16)
weights. A bf16 rounding now and then moves a token's k-th and (k+1)-th
router logits past each other, and that token then takes another expert;
over a prefill and three decode steps of two sequences the logits land
1-4% from the reference in norm (seeds 3-6; 1.6% on the seed here).
``REL_TOL`` is 0.07, between that and what fails (seeds 3-6; the seed
here): the same reference with every matrix product's inputs in float8
e4m3 (one precision below bf16) lands 11-13% away (12.6%), top-2 in place
of top-3 11-19% (11.2%), a rotary encoding added 12-16% (14.0%), no
shared expert 64-74% (73.6%) and no residual multiplier more than 100%.
"""

import copy
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import trace
from repro_torch.configs import granite_4_0_h_small as gcfg
from repro_torch.core import sa_serve as tserve
from repro_torch.models import (decode_moe_calls, decode_step, decoder, init_cache, init_params,
                                prefill)
from repro_torch.models import attention as tattn, decoding, granite_hybrid as tg, layers
from repro_torch.models import model as tmodel, moe as tmoe

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import granite_hybrid_reference as ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL_TOL = 0.07
SMALL = dict(gcfg.PUBLISHED, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=32, shared_intermediate_size=64, vocab_size=256,
             mamba_d_state=16, mamba_d_head=16, mamba_n_heads=8, num_hidden_layers=10,
             layer_types=gcfg.PUBLISHED["layer_types"][:10], num_local_experts=8,
             num_experts_per_tok=3)
PROMPT, STEPS = 70, 4  # 70 positions: two scan chunks, the second ragged


@pytest.fixture(scope="module")
def cfg():
    return gcfg.from_hf(SMALL)


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, 3, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, PROMPT + STEPS)))


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _leaves(tree):
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _port(cfg, params, tokens):
    """Prefill the prompt, then decode STEPS - 1 tokens teacher-forced
    through a decoder: the logits (B, STEPS, V)."""
    logits, cache, n = prefill(cfg, params, {"tokens": tokens[:, :PROMPT]},
                               max_len=PROMPT + STEPS)
    dec = decoder(cfg, params, cache)
    got = [logits] + [dec.step({"tokens": tokens[:, n + i:n + i + 1]}, n + i)
                      for i in range(STEPS - 1)]
    return torch.stack(got, 1)


def _ref(params, tokens, precision="float32"):
    return torch.stack([ref.logits(SMALL, params, tokens[b, :PROMPT + STEPS - 1], STEPS, precision)
                        for b in range(tokens.shape[0])])


@pytest.fixture(scope="module")
def want(params, tokens):
    return _ref(params, tokens)


def _zipf(seed: int, vocab: int, shape, exponent: float = 1.1) -> torch.Tensor:
    """Ids of Zipfian frequencies: rank r drawn ∝ r^-exponent, ranks mapped
    to ids by a permutation."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -exponent
    ranks = rng.choice(vocab, size=shape, p=p / p.sum())
    return torch.from_numpy(rng.permutation(vocab)[ranks])


# -- the configuration --------------------------------------------------------


def test_published_config():
    cfg = tconfigs.get_config("granite_4_0_h_small")
    assert cfg is gcfg.CONFIG and cfg.family == "granite_hybrid"
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_ngroups, cfg.ssm_conv_dim) == (40, 4096, 128, 64, 128, 1, 8448)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_experts, cfg.experts_per_token,
            cfg.d_ff, cfg.shared_d_ff, cfg.padded_vocab) == (32, 8, 128, 72, 10, 768, 1536, 100352)
    kinds = cfg.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    assert kinds.count("mamba") == 36
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.logits_scaling,
            cfg.attention_multiplier) == (12.0, 0.22, 16.0, 1 / 128)
    # every leaf: 32.21 B; the matrices, conv taps and routers alone (each
    # layer's slice two-dimensional, the embedding): 32,206 M
    assert cfg.param_count() == 32_207_337_984
    meta = init_params(cfg, 0, device="meta")
    assert sum(t.numel() for t in _leaves(meta)) == cfg.param_count()
    stacked = [t for name, tree in meta.items() if isinstance(tree, dict)
               for t in tree.values() if t.dim() >= 3]
    assert sum(t.numel() for t in stacked) + meta["embed"].numel() == 32_206_393_344
    assert sum(t.numel() * t.element_size() for t in _leaves(meta)) == 64_440_158_208
    # a prompt's cache at the cell's shapes: 1.21 GB of Mamba2 states, 0.55
    # GB of keys and values at 4160 positions
    cache = init_cache(cfg, 8, 4160, device="meta")
    assert cache["mamba"]["state"].numel() * 4 == 1_207_959_552
    assert sum(t.numel() * t.element_size() for t in _leaves(cache)) == 1_767_817_216


def test_port_archs_stay_beside_the_jax_list():
    assert "granite_4_0_h_small" in tconfigs.PORT_ARCH_IDS
    assert "granite_4_0_h_small" not in tconfigs.ARCH_IDS


@pytest.mark.parametrize("key,value", [("position_embedding_type", "rope"),
                                       ("num_local_experts", 0), ("num_experts_per_tok", 0),
                                       ("shared_intermediate_size", 0),
                                       ("mamba_conv_bias", False), ("hidden_act", "gelu"),
                                       ("tie_word_embeddings", False), ("mamba_n_heads", 64),
                                       ("layer_types", ["mamba"] * 39)])
def test_from_hf_refuses_what_the_port_does_not_implement(key, value):
    with pytest.raises(ValueError):
        gcfg.from_hf(dict(gcfg.PUBLISHED, **{key: value}))


def test_small_config_keeps_every_mechanism(cfg):
    red = tconfigs.reduced_config(gcfg.CONFIG)
    for c in (cfg, red):
        assert c.num_layers == 10 and c.layer_kinds().count("attn") == 1
        assert (c.num_experts, c.experts_per_token) == (8, 3) and c.shared_d_ff > 0
        assert c.num_heads > c.num_kv_heads
        assert (c.embedding_multiplier, c.residual_multiplier, c.logits_scaling) == (12, 0.22, 16)


def test_init_draws(params, cfg):
    assert params["embed"].dtype == torch.bfloat16 and params["moe"]["router"].dtype == torch.float32
    assert params["moe"]["w_gate"].shape == (10, 8, 64, 32)
    assert params["moe"]["w_down"].shape == (10, 8, 32, 64)
    assert params["mamba"]["in_proj"].shape[0] == 9 and params["attn"]["wk"].shape == (1, 64, 32)
    dt = torch.nn.functional.softplus(params["mamba"]["dt_bias"])
    assert float(dt.min()) >= tg.DT_MIN * 0.999 and float(dt.max()) <= tg.DT_MAX * 1.001
    again = init_params(cfg, 3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(params), _leaves(again)))


def test_the_logits_do_not_repeat_the_input(want, tokens):
    """The tied head over the embedding-led stream does not hand each
    position its own token (the final norm's scale is drawn around 0)."""
    picks = want.argmax(-1)
    assert (picks != tokens[:, PROMPT - 1:PROMPT + STEPS - 1]).all()


# -- the MoE ------------------------------------------------------------------


def _moe_params(seed, e=8, d=64, f=32):
    gen = torch.Generator().manual_seed(seed)
    mat = lambda *s: (torch.randn(*s, generator=gen) / s[-2] ** 0.5).to(torch.bfloat16)  # noqa: E731
    return {"router": torch.randn(d, e, generator=gen) / d ** 0.5, "w_gate": mat(e, d, f),
            "w_up": mat(e, d, f), "w_down": mat(e, f, d), "shared_gate": mat(d, 2 * f),
            "shared_up": mat(d, 2 * f), "shared_down": mat(2 * f, d)}


@pytest.mark.parametrize("chunk", [tmoe.DISPATCH_TOKENS, 7])
def test_dropless_equals_the_capacity_path_where_nothing_drops(chunk, monkeypatch):
    """At a capacity of every token the static path drops nothing; the
    sorted segments (in one chunk, or in chunks of 7 tokens) give its
    numbers to within one bf16 rounding of each output."""
    p = _moe_params(1)
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    args = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    monkeypatch.setattr(tmoe, "DISPATCH_TOKENS", chunk)
    got = tmoe.moe_ffn_dropless(*args, k=3)
    want = tmoe.moe_ffn_local(*args, k=3, dropless_threshold=50 * 3)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-7)


def test_moe_block_within_bf16_roundings_of_the_reference():
    """The routed and shared experts, dropless, against the reference's
    per-expert float32 computation on the same input (router ties aside:
    random inputs leave none within a rounding)."""
    p = _moe_params(4)
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    got = tmoe.moe_ffn_shared(x, p, k=3, dropless=True)
    stacked = {k: v[None] for k, v in p.items()}
    want = ref._moe(x.float(), stacked, 0, {"num_experts_per_tok": 3}, "float32")
    assert _rel(got, want) < 0.01
    static = tmoe.moe_ffn_shared(x, p, k=3, dropless=False)
    assert _rel(static, want) < 0.01


def test_dispatch_spans_count_pairs_loads_and_one_sync(cfg, params, tokens):
    """Each layer's dropless MoE in a prefill is one ``moe.dispatch`` span:
    every (token, expert) pair kept, its loads and one host read; a decode
    step records none."""
    with trace.recording():
        _, cache, n = prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, max_len=PROMPT + 2)
        decoder(cfg, params, cache).step({"tokens": tokens[:, n:n + 1]}, n)
    spans = [sp for sp in trace.records() if sp.name == "moe.dispatch"]
    assert len(spans) == cfg.num_layers and all(sp.layer == "moe" for sp in spans)
    pairs = 2 * PROMPT * cfg.experts_per_token
    for sp in spans:
        assert sp.attrs["pairs"] == pairs and sp.attrs["syncs"] == 1
        assert 1 <= sp.attrs["experts_hit"] <= cfg.num_experts
        assert pairs / cfg.num_experts <= sp.attrs["max_load"] <= 2 * PROMPT


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS + tconfigs.PORT_ARCH_IDS)
def test_decode_moe_calls_counts_a_step(monkeypatch, arch):
    """The model's count is the MoE calls a decode step makes: one step of
    each family's reduced model on the CPU, its calls counted."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    calls = []

    def counted(fn):
        def call(*args, **kwargs):
            calls.append(1)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tmodel, "moe_ffn", counted(tmodel.moe_ffn))
    monkeypatch.setattr(tmoe, "moe_ffn_shared", counted(tmoe.moe_ffn_shared))
    params = init_params(cfg, 0, device="cpu")
    batch = ({"frame_embeds": torch.zeros(1, 1, cfg.d_model, dtype=torch.bfloat16)}
             if cfg.family == "audio" else {"tokens": torch.ones(1, 1, dtype=torch.long)})
    decode_step(cfg, params, batch, init_cache(cfg, 1, 8, device="cpu"), 3)
    assert len(calls) == decode_moe_calls(cfg)


# -- the port against the reference ------------------------------------------


def test_prefill_and_decode_match_the_full_forward(cfg, params, tokens, want):
    """Prefill, then three decode steps through a decoder (its two sets of
    buffers taken in turn), each step's logits against the reference's full
    forward over the prompt and the tokens so far; the prompt's cache is
    not modified."""
    logits, cache, n = prefill(cfg, params, {"tokens": tokens[:, :PROMPT]},
                               max_len=PROMPT + STEPS)
    kept = [t.clone() for t in _leaves(cache)]
    dec = decoder(cfg, params, cache)
    got, written = [logits], []
    for i in range(STEPS - 1):
        got.append(dec.step({"tokens": tokens[:, n + i:n + i + 1]}, n + i))
        written.append(dec.last)
    assert want.shape == (2, STEPS, cfg.padded_vocab)
    assert _rel(torch.stack(got, 1), want) < REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cache), kept))
    assert isinstance(dec, decoding.Decoder) and written == [0, 1, 0]
    assert all(s["k"] is not cache["k"] for s in dec.sets)


def test_the_float8_control_fails_the_tolerance(params, tokens, want):
    assert _rel(_ref(params, tokens, "float8_e4m3"), want) > REL_TOL


def _no_shared(cfg, params, monkeypatch):
    params["moe"]["shared_down"].zero_()
    return cfg


def _no_residual_multiplier(cfg, params, monkeypatch):
    return dataclasses.replace(cfg, residual_multiplier=1.0)


def _top_k_minus_1(cfg, params, monkeypatch):
    return dataclasses.replace(cfg, experts_per_token=cfg.experts_per_token - 1)


def _rotary_added(cfg, params, monkeypatch):
    """q and k rotated by their positions (RoPE θ 10⁴), prefill and decode."""
    qkv = tg._qkv

    def rotated(u, p, c, positions=None):
        q, k, v = qkv(u, p, c)
        pos = positions if positions is not None else torch.arange(u.shape[1])[None]
        return layers.apply_rope(q, pos, 1e4), layers.apply_rope(k, pos, 1e4), v

    decode = tg.decode_attention

    def decode_rotated(q, kc, vc, cur_len, **kw):
        pos = (cur_len - 1).view(1, 1)
        kc.index_copy_(1, pos.view(1), layers.apply_rope(kc.index_select(1, pos.view(1)), pos, 1e4))
        return decode(layers.apply_rope(q, pos, 1e4), kc, vc, cur_len, **kw)

    monkeypatch.setattr(tg, "_qkv", rotated)
    monkeypatch.setattr(tg, "decode_attention", decode_rotated)
    return cfg


@pytest.mark.parametrize("mutate", [_no_shared, _no_residual_multiplier, _top_k_minus_1,
                                    _rotary_added],
                         ids=["no_shared_expert", "no_residual_multiplier", "top_k_minus_1",
                              "rotary_added"])
def test_each_mechanism_removed_fails_the_tolerance(cfg, params, tokens, want, mutate,
                                                    monkeypatch):
    broken = copy.deepcopy(params)
    c = mutate(cfg, broken, monkeypatch)
    assert _rel(_port(c, broken, tokens), want) > REL_TOL


def test_dropless_holds_where_the_capacity_rule_drops(cfg, params, monkeypatch):
    """A prompt of 2 × 700 Zipfian ids (1400 tokens × 3 choices, past the
    capacity rule's 4096 pairs): the dropless prefill is within the
    tolerance of the reference; the capacity rule (1.25 × the mean load an
    expert) drops pairs in the uneven loads and fails it."""
    toks = _zipf(7, cfg.vocab_size, (2, 700))
    want = torch.stack([ref.logits(SMALL, params, toks[b], 1)[0] for b in range(2)])
    got = prefill(cfg, params, {"tokens": toks}, max_len=700)[0]
    assert _rel(got, want) < REL_TOL
    dropped = []

    def capacity_rule(x, rw, wg, wu, wd, *, k):
        cap = tmoe.capacity(x.shape[0], k, rw.shape[1], 1.25)
        dropped.append(int((~tmoe.slots(tmoe.route(x, rw, k)[1], rw.shape[1], cap)[1]).sum()))
        return tmoe.moe_ffn_local(x, rw, wg, wu, wd, k=k)

    monkeypatch.setattr(tmoe, "moe_ffn_dropless", capacity_rule)
    bad = prefill(cfg, params, {"tokens": toks}, max_len=700)[0]
    assert sum(dropped) > 0
    assert _rel(bad, want) > REL_TOL


def test_the_card_route_hands_the_kernels_their_shapes(cfg, params, tokens, monkeypatch):
    """Prefill down the card's path, each kernel's plain version in its
    place: the attention kernel gets bf16 q (4 heads) and k, v (2 kv heads)
    laid out for TMA with the config's scale and no window, the scan the 8
    Mamba2 heads (the one group's B and C copied to every head); the
    logits stay within the bf16 rounding of the CPU path's."""
    from repro_torch.kernels import flash_attention as tfa, ops as kops, ref as kref

    want = prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, max_len=PROMPT)[0]
    attn, scans = [], []

    def attention(q, k, v, **kw):
        assert all(tfa.tma_layout_error(t) is None for t in (q, k, v))
        attn.append((q.shape[2], k.shape[2], kw["scale"], kw["causal"], kw["window"]))
        return kref.flash_attention_blocked(q, k, v, **kw)

    def scan(x, a, b, c, chunk):
        scans.append((x.shape[2], a.dim(), b.shape, c.shape))
        return kref.ssm_scan_chunked(x, a, b, c, chunk=chunk)

    monkeypatch.setattr(kops, "_on_card", lambda t, use_kernel: True)
    monkeypatch.setattr(tattn, "flash_attention_cuda", attention)
    monkeypatch.setattr(kops.ssm_scan_kernel, "ssm_scan_cuda", scan)
    got = prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, max_len=PROMPT)[0]
    assert attn == [(4, 2, 1 / 128, True, None)]
    assert scans == [(8, 3, (2, PROMPT, 8, 16), (2, PROMPT, 8, 16))] * 9
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
    assert [sp.attrs for sp in by["serve.prefill"]] == [{"tokens": 32, "batch": 2}] * 2
    assert [sp.attrs for sp in by["serve.generate"]] == [{"steps": 3}] * 4
    assert len(by["serve.decode_step"]) == 12
    assert [sp.attrs["pairs"] for sp in by["moe.dispatch"]] == [32 * 3] * (2 * cfg.num_layers)


def test_training_forward_refuses():
    from repro_torch.models import forward_train

    with pytest.raises(NotImplementedError):
        forward_train(gcfg.from_hf(SMALL), {}, {"tokens": torch.zeros(1, 2)})


# -- the reference -------------------------------------------------------------


def test_the_reference_is_the_benchmarks_copy_and_imports_no_program():
    import ast

    text = (ROOT / "tests" / "granite_hybrid_reference.py").read_text()
    assert text == (ROOT / "perfbench" / "reference" / "granite_hybrid.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "torch"}


def test_reference_moe_is_each_tokens_top_k():
    """The reference's per-expert MoE against each token's own top-k sum,
    token by token, in float32 (the same products in another order)."""
    p = {k: v.float()[None] for k, v in _moe_params(6, e=5, d=8, f=4).items()}
    u = torch.randn(9, 8, generator=torch.Generator().manual_seed(7))
    got = ref._moe(u, p, 0, {"num_experts_per_tok": 2}, "float32")
    silu = torch.nn.functional.silu
    for t in range(9):
        logits = u[t] @ p["router"][0]
        top = torch.topk(logits, 2)
        want = (silu(u[t] @ p["shared_gate"][0]) * (u[t] @ p["shared_up"][0])) @ p["shared_down"][0]
        for g, e in zip(torch.softmax(top.values, 0), top.indices):
            want = want + g * ((silu(u[t] @ p["w_gate"][0, e]) * (u[t] @ p["w_up"][0, e]))
                               @ p["w_down"][0, e])
        torch.testing.assert_close(got[t], want, rtol=1e-5, atol=1e-5)


# -- the card ------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_prefill_and_decode_at_published_widths(card):
    """One period of the layer pattern (10 layers, the attention at 5) at
    the published widths on the card: prefill runs the scan kernel in each
    Mamba2 layer and the tensor-core attention, the dropless MoE keeps
    every pair, and prefill and decode through a decoder (its steps
    replayed as CUDA graphs) are within the tolerance of the float32
    reference; the float8 control is not. Then a serve study at these
    widths through ``run_sa_serve``."""
    from repro_torch.kernels import decode_attention as tda, flash_attention as tfa
    from repro_torch.kernels import ssm_scan as tss

    pub = dict(gcfg.PUBLISHED, num_hidden_layers=10, layer_types=gcfg.PUBLISHED["layer_types"][:10])
    cfg = gcfg.from_hf(pub)
    params = init_params(cfg, torch.Generator(device=card).manual_seed(7), device=card)
    toks = _zipf(8, cfg.vocab_size, (2, 515)).to(card)
    fa0, ss0 = tfa.WGMMA_LAUNCHES.value, tss.LAUNCHES.value
    with trace.recording():
        logits, cache, n = prefill(cfg, params, {"tokens": toks[:, :512]}, max_len=516)
    assert (tfa.WGMMA_LAUNCHES.value - fa0, tss.LAUNCHES.value - ss0) == (1, 9)
    pairs = [sp.attrs["pairs"] for sp in trace.records() if sp.name == "moe.dispatch"]
    assert pairs == [2 * 512 * 10] * 10
    calls = tda.CALLS.value
    dec = decoder(cfg, params, cache)
    got = [logits] + [dec.step({"tokens": toks[:, n + i:n + i + 1]}, n + i) for i in range(3)]
    assert tda.CALLS.value - calls == 1 + 3  # the warm-up step before the captures, three replays
    got = torch.stack(got, 1)
    for b in range(2):
        want = ref.logits(pub, params, toks[b, :515], 4)
        assert _rel(got[b], want) < REL_TOL, b
        low = ref.logits(pub, params, toks[b, :515], 4, "float8_e4m3")
        assert _rel(low, want) > REL_TOL, b
    prompts = {p: toks[:, :64].roll(p, 1).cpu().numpy() for p in range(2)}
    sets = [tuple(sorted({"prompt_id": p, "rep_penalty": 1.0, "top_k": 40,
                          "threshold": 0.5}.items())) for p in range(2)]
    out = tserve.run_sa_serve(cfg, params, prompts, sets, gen_len=4, max_len=68)
    assert all(out["ids"][rid].shape == (2, 4) for rid in range(2))


@pytest.mark.gpu
def test_card_scan_at_the_published_state_size(card):
    """The ``ssm_scan`` kernel at a prefill's shapes, (8, 4096, 128 heads, N
    128, P 64) in bf16 with a per-head decay: N·P = 8192 passes the 4096
    that the kernel keeps in registers, so the state takes the kernel's
    other path. Against ``ssm_scan_three_pass`` on the same inputs: the
    final state to 1e-3 (fp32 sums in another order), y to one bf16
    rounding (the kernel rounds y to bf16 once)."""
    from repro_torch.kernels import ops as kops, ref as kref, ssm_scan as tss

    gen = torch.Generator(device=card).manual_seed(11)
    b, s, h, n, p = 8, 4096, 128, 128, 64
    x = torch.randn((b, s, h, p), generator=gen, device=card).to(torch.bfloat16)
    bb = (0.5 * torch.randn((b, s, h, n), generator=gen, device=card) / n ** 0.5).to(torch.bfloat16)
    c = (0.5 * torch.randn((b, s, h, n), generator=gen, device=card)).to(torch.bfloat16)
    a = torch.exp(-torch.exp(torch.randn((b, s, h), generator=gen, device=card) * 0.7 - 3.0))
    before = tss.LAUNCHES.value
    y, hf = kops.ssm_scan(x, a, bb, c)
    torch.cuda.synchronize()
    assert tss.LAUNCHES.value == before + 1
    for i in range(0, b, 2):  # two sequences at a time: the plain passes' fp32 buffers
        yp, hp = kref.ssm_scan_three_pass(x[i:i + 2], a[i:i + 2], bb[i:i + 2], c[i:i + 2])
        torch.testing.assert_close(hf[i:i + 2], hp, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(y[i:i + 2].float(), yp.float(), rtol=2**-7, atol=2**-7)
