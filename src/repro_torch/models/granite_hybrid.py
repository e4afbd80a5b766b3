"""IBM's Granite 4.0-H (the ``granite_hybrid`` family:
:class:`repro_torch.configs.GraniteHybridConfig`, ``configs/granite_4_0_h_small.py``):
parameters, cache, prefill and decode, reached through
:mod:`repro_torch.models.model`'s entry points.

With ``x = embedding_multiplier · E[tokens]`` and ``r`` the residual
multiplier, every layer ℓ computes, as ``transformers``'
``GraniteMoeHybridDecoderLayer`` does:

    x ← x + r · Mixer_ℓ(RMSNorm(x))       Mamba2, or GQA attention with no
                                          positional encoding, logits
                                          scaled by attention_multiplier
    u = RMSNorm(x)
    x ← x + r · (Σ_{top k} g_e · SwiGLU_e(u) + SwiGLU_shared(u))

with ``g`` the softmax of the router's top-k logits; then the final RMSNorm
and the LM head tied to the embedding, its logits over ``logits_scaling``.
Mamba2 is :func:`repro_torch.models.ssm.mamba2_grouped_block` (one group of
B and C, the gated norm over the whole inner width); the MoE is
:func:`repro_torch.models.moe.moe_ffn_shared`.

Prefill runs the ``ssm_scan`` kernel in each Mamba2 layer, the tensor-core
``flash_attention`` kernel in each attention layer, and the dropless MoE
(one host read of the experts' loads a layer). Decode updates each Mamba2
state in O(1), attends against each attention layer's KV cache with the
``decode_attention`` kernel, and runs the MoE with static shapes (every
expert over the batch's slots), all in place (:func:`_step`), a generate's
steps replayed as CUDA graphs on the card
(:class:`repro_torch.models.decoding.Decoder`). Norms scale by ``1 +
weight``, as everywhere in the port. Matrices are held in bf16; norms,
biases, decays, skips and the router in fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import GraniteHybridConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import blocked_attention, decode_attention
from repro_torch.models.layers import COMPUTE_DTYPE, matmul, normal_init, normal_stack
from repro_torch.models.layers import rms_norm_fused as _rms

__all__ = ["init_params", "init_cache", "prefill"]

# init scales of the random weights. The tied head gives logits of std
# about sqrt(d)·EMBED_STD / logits_scaling (3 at the published widths); the
# final norm's scale is drawn around 0 (N(0, 1)), or each position's own
# token, which the embedding multiplier makes a large part of the
# stream, would take the largest logit and every step would repeat its
# input. The 2·L branches (mixers, routed experts, shared experts) add about
# STREAM_STD per channel to the stream in all, after the residual
# multiplier: each branch's output a std of STREAM_STD / (r·sqrt(2L)), 8.1
# at one period of 10 layers and 4.1 at 40 (a depth-scaled init): larger
# branches at 40 layers amplified the bf16 roundings to a fifth of the
# logits' norm. The router's logits have a std of ROUTER_LOGIT_STD, so that
# a token's top k gates are uneven. Attention's q and k are drawn so that
# its logits have a std of about ATTN_LOGIT_STD at the config's scale
# (1/head_dim at the published widths, which would leave unit q and k
# attending almost uniformly).
EMBED_STD = 0.75
STREAM_STD = 8.0
ATTN_LOGIT_STD = 3.0
ROUTER_LOGIT_STD = 4.0
DT_MIN, DT_MAX = 1e-3, 1e-1  # Mamba2's time-step range


def _slots(cfg: GraniteHybridConfig):
    """Each layer's (kind, index among the layers of its kind)."""
    seen = {"mamba": 0, "attn": 0}
    out = []
    for kind in cfg.layer_kinds():
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def init_params(cfg: GraniteHybridConfig, gen: Optional[torch.Generator], dev: torch.device,
                wdt: torch.dtype) -> Dict[str, Any]:
    """Random parameters from ``gen`` (None on the meta device). Keys:
    ``embed`` (V, D), ``final_norm``, ``ln1`` and ``ln2`` (L, D): each
    layer's norms before its mixer and its MoE; ``mamba``, the Mamba2
    layers', stacked; ``attn``, the attention layers' ``wq``, ``wk``,
    ``wv``, ``wo``; ``moe``, each layer's ``router`` (D, E) fp32, experts
    ``w_gate``, ``w_up`` (E, D, F) and ``w_down`` (E, F, D), and shared
    expert ``shared_gate``, ``shared_up`` (D, Fs) and ``shared_down`` (Fs,
    D)."""
    d, f, fs, e = cfg.d_model, cfg.d_ff, cfg.shared_d_ff, cfg.num_experts
    d_in, h, conv = cfg.ssm_expand * d, cfg.ssm_heads, cfg.ssm_conv_dim
    kinds = cfg.layer_kinds()
    L, nm, na = cfg.num_layers, kinds.count("mamba"), kinds.count("attn")
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    f32 = torch.float32
    branch = STREAM_STD / (cfg.residual_multiplier * math.sqrt(2 * L))
    # q and k of std qk each: logits of std qk² · sqrt(head_dim) · scale
    qk = math.sqrt(ATTN_LOGIT_STD / (math.sqrt(cfg.head_dim) * cfg.attention_multiplier))
    # SwiGLU of unit gate and up has a std of about 0.6 per channel; the
    # routed experts' weighted sum about 0.6 / sqrt(k) at even gates
    swiglu_std = 0.6

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    def mat(lead, *shape, std=None, dtype=wdt):
        return normal_stack(gen, lead, shape, std, dtype, dev)

    def experts(*shape, std=None):  # (L, E, ...), drawn an expert at a time
        out = torch.empty((L, e, *shape), dtype=wdt, device=dev)
        if gen is not None:
            for i in range(L):
                out[i] = normal_stack(gen, e, shape, std, wdt, dev)
        return out

    if gen is None:
        dt_bias, a_log = torch.empty((nm, h), device=dev), torch.empty((nm, h), device=dev)
    else:
        # dt log-uniform in [DT_MIN, DT_MAX] through softplus's inverse; A = -(1..H)
        u = torch.rand((nm, h), generator=gen, device=dev)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        dt_bias = dt + torch.log(-torch.expm1(-dt))
        a_log = torch.log(torch.arange(1, h + 1, dtype=f32, device=dev)).expand(nm, h).clone()
    return {
        "embed": normal_init(gen, (cfg.padded_vocab, d), EMBED_STD, dtype=wdt, device=dev)
        if gen is not None else torch.empty((cfg.padded_vocab, d), dtype=wdt, device=dev),
        "final_norm": normal_init(gen, (d,), 1.0, device=dev) - 1.0
        if gen is not None else zeros(d),
        "ln1": zeros(L, d),
        "ln2": zeros(L, d),
        "mamba": {
            "in_proj": mat(nm, d, d_in + conv + h),
            "conv_w": mat(nm, ssm_mod._CONV_K, conv, std=0.5),
            "conv_b": mat(nm, conv, std=0.1, dtype=f32),
            "dt_bias": dt_bias,
            "a_log": a_log,
            "d_skip": torch.ones((nm, h), dtype=f32, device=dev),
            "norm": zeros(nm, d_in),
            "out_proj": mat(nm, d_in, d, std=branch / math.sqrt(d_in)),
        },
        "attn": {
            "wq": mat(na, d, hq, std=qk / math.sqrt(d)),
            "wk": mat(na, d, hkv, std=qk / math.sqrt(d)),
            "wv": mat(na, d, hkv),
            "wo": mat(na, hq, d, std=branch / math.sqrt(hq)),
        },
        "moe": {
            "router": mat(L, d, e, std=ROUTER_LOGIT_STD / math.sqrt(d), dtype=f32),
            "w_gate": experts(d, f),
            "w_up": experts(d, f),
            "w_down": experts(f, d, std=branch * math.sqrt(cfg.experts_per_token)
                              / (swiglu_std * math.sqrt(f))),
            "shared_gate": mat(L, d, fs),
            "shared_up": mat(L, d, fs),
            "shared_down": mat(L, fs, d, std=branch / (swiglu_std * math.sqrt(fs))),
        },
    }


def init_cache(cfg: GraniteHybridConfig, batch: int, max_len: int,
               dev: torch.device) -> Dict[str, Any]:
    """Zeros: each Mamba2 layer's state and conv carry under ``"mamba"``
    (Mamba2 layer, ...), and each attention layer's keys and values
    (attention layer, B, max_len, kv heads, head_dim) bf16 under ``"k"``
    and ``"v"``: two kinds of state side by side."""
    kinds = cfg.layer_kinds()
    mam = ssm_mod.mamba2_grouped_init_cache(cfg, batch, COMPUTE_DTYPE, device="meta")
    kv_shape = (kinds.count("attn"), batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "mamba": {k: torch.zeros((kinds.count("mamba"), *v.shape), dtype=v.dtype, device=dev)
                  for k, v in mam.items()},
        "k": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
        "v": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
    }


def _layer(tree: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in tree.items()}


def _embed(cfg: GraniteHybridConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    x = emb[tokens.to(device=emb.device, dtype=torch.long)].float()
    return (x * cfg.embedding_multiplier).to(COMPUTE_DTYPE)


def _logits(cfg: GraniteHybridConfig, params, x_last: torch.Tensor) -> torch.Tensor:
    """(B, D) -> fp32 (B, V) through the head tied to the embedding, over
    the logits scaling."""
    h = matmul(_rms(x_last, params["final_norm"], cfg.norm_eps), params["embed"].t())
    return h.float() / cfg.logits_scaling


def _qkv(u: torch.Tensor, p, cfg: GraniteHybridConfig):
    """q (B, S, heads, hd), k and v (B, S, kv heads, hd): no positional
    encoding."""
    b, s, _ = u.shape
    q = matmul(u, p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = matmul(u, p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = matmul(u, p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _residual(x: torch.Tensor, y: torch.Tensor, cfg: GraniteHybridConfig) -> torch.Tensor:
    return x + y * cfg.residual_multiplier


def _moe(x: torch.Tensor, params, layer: int, cfg: GraniteHybridConfig, *,
         dropless: bool) -> torch.Tensor:
    """The layer's MoE block on the stream: RMSNorm, routed and shared
    experts, the residual."""
    b, s, d = x.shape
    u = _rms(x, params["ln2"][layer], cfg.norm_eps).reshape(b * s, d)
    y = moe_mod.moe_ffn_shared(u, _layer(params["moe"], layer), k=cfg.experts_per_token,
                               dropless=dropless)
    return _residual(x, y.reshape(b, s, d), cfg)


def prefill(cfg: GraniteHybridConfig, params, tokens: torch.Tensor, max_len: int):
    """Returns (last-position logits fp32 (B, V), filled cache, length)."""
    x = _embed(cfg, params, tokens)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_len, x.device)
    for layer, (kind, i) in enumerate(_slots(cfg)):
        u = _rms(x, params["ln1"][layer], cfg.norm_eps)
        if kind == "attn":
            p = _layer(params["attn"], i)
            q, k, v = _qkv(u, p, cfg)
            o = blocked_attention(q, k, v, window=s, scale=cfg.attention_multiplier)
            y = matmul(o.reshape(b, s, -1), p["wo"])
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
            del q, k, v, o
        else:
            y, c = ssm_mod.mamba2_grouped_block(u, _layer(params["mamba"], i), cfg,
                                                return_cache=True)
            cache["mamba"]["state"][i] = c["state"]
            cache["mamba"]["conv"][i] = c["conv"]
        del u
        x = _moe(_residual(x, y, cfg), params, layer, cfg, dropless=True)
    return _logits(cfg, params, x[:, -1]), cache, s


def _step(cfg: GraniteHybridConfig, params, tokens: torch.Tensor, pos: torch.Tensor, cache):
    """One decode step in place: the token (B, 1) at position ``pos`` (a
    0-d long tensor on the device) writes its keys and values at ``pos`` of
    each attention layer's cache and updates every Mamba2 state and conv
    carry of ``cache``; returns the logits fp32 (B, V). Reads no host value,
    so that it can be captured as a CUDA graph."""
    x = _embed(cfg, params, tokens)
    b = x.shape[0]
    for layer, (kind, i) in enumerate(_slots(cfg)):
        u = _rms(x, params["ln1"][layer], cfg.norm_eps)
        if kind == "attn":
            p = _layer(params["attn"], i)
            q, k, v = _qkv(u, p, cfg)
            cache["k"][i].index_copy_(1, pos.view(1), k)
            cache["v"][i].index_copy_(1, pos.view(1), v)
            o = decode_attention(q, cache["k"][i], cache["v"][i], pos + 1, window=2**30,
                                 scale=cfg.attention_multiplier)
            y = matmul(o.reshape(b, 1, -1), p["wo"])
        else:
            c = _layer(cache["mamba"], i)
            y = ssm_mod.mamba2_grouped_decode(u, _layer(params["mamba"], i), cfg, c, c)
        x = _moe(_residual(x, y, cfg), params, layer, cfg, dropless=False)
    return _logits(cfg, params, x[:, 0])
