"""Models built from a config: parameter init, the training forward
(:func:`forward_train`, the mean token cross-entropy), prefill and decode,
for every family of the JAX package's ``repro.models.model``:
  * ``dense`` / ``moe`` / ``vlm`` / ``audio``: pre-norm transformer blocks
    (GQA + RoPE + a SwiGLU FFN, or top-k MoE: :mod:`repro_torch.models.moe`),
    each layer with its window from ``cfg.layer_windows`` (gemma3's 5:1
    local:global, Mixtral's sliding window). vlm puts its patch embeddings
    before the tokens and attends bidirectionally over that prefix
    (prefix-LM); audio takes frame embeddings and has one head per codebook,
    its logits (B, codebooks * padded vocab). Prefill attention runs the
    ``flash_attention`` kernels;
  * ``hybrid`` (Zamba2): 9 super-blocks of 6 Mamba2 layers (``ssm_scan``
    with a per-head decay), with ONE weight-shared attention+MLP block
    applied after every super-block; its prefill attention runs the
    ``flash_attention`` kernel;
  * ``ssm`` (RWKV-6): time mixing runs the ``ssm_scan`` kernel;
  * ``zamba2`` (Zyphra's Zamba2-7B, a family of the port alone): Mamba2
    with grouped B and C, and two alternating shared blocks over the
    concatenated embedding with per-use adapters, in
    :mod:`repro_torch.models.zamba2`; served only, on one device.
An unknown family raises ``ValueError``, as in the JAX package.

Training takes the plain versions of the kernels on either device (the
kernels compute no gradient; the JAX package's ``forward_train`` never
reaches a Pallas kernel off the TPU), and recomputes each layer (each
Zamba2 super-block) in the backward pass, as the JAX package's
``jax.checkpoint(..., nothing_saveable)`` does.

Parameters are a dict of tensors with the JAX package's keys; per-layer
weights are stacked on leading dims and walked with Python loops. The
matrices that the JAX package casts to bf16 at every use (the projections,
the conv taps, the low-rank decay's first factor, the experts, the
embedding and the LM head) are held in bf16 once, as
``launch/steps.cast_for_compute`` does there: the cast is deterministic, so
the numbers are the same, and decoding does not re-cast billions of
parameters a token. Everything else (norms, biases, decays, skips, the MoE
router) stays fp32. For training, ``masters=True`` keeps every leaf in
fp32, as the JAX package's ``init_params`` returns them; the train step casts
them for each forward (:func:`repro_torch.launch.steps.cast_for_compute`).

``ctx`` (a :class:`repro_torch.dist.ParallelCtx`) is None on one device.
On a mesh the parameters and inputs are DTensors and the model runs on
DTensors: the hidden stream is laid out batch over the data-parallel axes
(``constrain_hidden``), q, k and v heads over 'model' (``constrain_qkv``),
attention, the SSM scans and the MoE dispatch run on each rank's shard
through ``local_map``, and the plain tensors the model makes itself
(positions, masks, caches) enter as replicated
(``dist.sharding.replicate_plain``). The outputs are DTensors, the training
loss a plain scalar on every rank. ``ctx.analysis`` stubs the SSM scan,
whose cost the dry-run adds in closed form.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (P, as_dtensor, batch_spec, constrain_hidden, constrain_qkv,
                                       on_mesh, placements, replicate_plain, shard_map_compat)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import zamba2
from repro_torch.models.attention import blocked_attention, decode_attention
from repro_torch.models.layers import (COMPUTE_DTYPE, apply_rope, cross_entropy, dense_ffn,
                                      matmul, normal_init, rms_norm, token_nll)
from repro_torch.models.moe import moe_ffn

__all__ = ["init_params", "params_from_jax", "forward_train", "init_cache", "prefill",
           "decode_step", "decoder"]

# held in bf16 (see the module docstring), by leaf name: RWKV-6's, then
# Zamba2's and the transformers' (no name of one family names an fp32 leaf
# of another); ``w_lora_b`` and the MoE ``router`` are used in fp32
BF16_WEIGHTS = frozenset({
    "embed", "lm_head",
    "w_r", "w_k", "w_v", "w_g", "w_lora_a", "w_o", "w_ck", "w_cv", "w_cr",
    "in_proj", "conv_w", "out_proj", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
})

_TRANSFORMERS = ("dense", "moe", "vlm", "audio")
_FAMILIES = _TRANSFORMERS + ("hybrid", "ssm", "zamba2")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(cfg.family)


def _zamba2_off_mesh(ctx) -> None:
    if on_mesh(ctx):
        raise NotImplementedError("the zamba2 family runs on one device")


def _analysis(ctx) -> bool:
    return bool(ctx is not None and getattr(ctx, "analysis", False))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _rwkv_params(gen: torch.Generator, cfg: ModelConfig, layers: int, dev: torch.device,
                 wdt: torch.dtype):
    d, f = cfg.d_model, cfg.d_ff
    lora = 64

    def mat(*s, std=None, dtype=wdt):
        return normal_init(gen, (layers, *s), std, dtype=dtype, device=dev)

    def full(value):
        return torch.full((layers, d), value, dtype=torch.float32, device=dev)

    return {
        "ln1": full(0.0),
        "ln2": full(0.0),
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5), "mu_g": full(0.5),
        "mu_w": full(0.5),
        "w_r": mat(d, d),
        "w_k": mat(d, d),
        "w_v": mat(d, d),
        "w_g": mat(d, d),
        "w0": full(-0.6),
        "w_lora_a": mat(d, lora, std=0.02),
        "w_lora_b": mat(lora, d, std=0.02, dtype=torch.float32),
        "u": full(0.5),
        "ln_w": full(1.0),
        "ln_b": full(0.0),
        "w_o": mat(d, d),
        "mu_ck": full(0.5), "mu_cr": full(0.5),
        "w_ck": mat(d, f),
        "w_cv": mat(f, d),
        "w_cr": mat(d, d),
    }


def _attn_params(gen: torch.Generator, cfg: ModelConfig, dev: torch.device, wdt: torch.dtype,
                 lead=()):
    """Attention projections, stacked on the ``lead`` dims (the shared
    block: none; a transformer: its layers)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def mat(*s, std=None):
        return normal_init(gen, (*lead, *s), std, dtype=wdt, device=dev)

    return {
        "wq": mat(d, h * hd),
        "wk": mat(d, kv * hd),
        "wv": mat(d, kv * hd),
        "wo": mat(h * hd, d, std=1.0 / math.sqrt(h * hd)),
    }


def _ffn_params(gen: torch.Generator, cfg: ModelConfig, dev: torch.device, wdt: torch.dtype,
                lead=()):
    """A SwiGLU FFN, or ``cfg.num_experts`` of them and their fp32 router,
    stacked on the ``lead`` dims (the shared block: none)."""
    d, f = cfg.d_model, cfg.d_ff

    def mat(*s, std=None, dtype=wdt):
        return normal_init(gen, (*lead, *s), std, dtype=dtype, device=dev)

    if cfg.num_experts:
        e = cfg.num_experts
        return {
            "router": mat(d, e, std=0.02, dtype=torch.float32),
            "w_gate": mat(e, d, f, std=1.0 / math.sqrt(d)),
            "w_up": mat(e, d, f, std=1.0 / math.sqrt(d)),
            "w_down": mat(e, f, d, std=1.0 / math.sqrt(f)),
        }
    return {"w_gate": mat(d, f), "w_up": mat(d, f), "w_down": mat(f, d)}


def _mamba_params(gen: torch.Generator, cfg: ModelConfig, dev: torch.device, wdt: torch.dtype):
    """Every Mamba2 layer's weights, stacked (super-blocks, layers a block)."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n, h = cfg.ssm_state, cfg.ssm_heads
    nb, ae = cfg.num_layers // cfg.attn_every, cfg.attn_every

    def mat(*s, std=None):
        w = normal_init(gen, (cfg.num_layers, *s), std, dtype=wdt, device=dev)
        return w.reshape(nb, ae, *s)

    def full(size, value):
        return torch.full((nb, ae, size), value, dtype=torch.float32, device=dev)

    return {
        "ln": full(d, 0.0),
        "in_proj": mat(d, 2 * d_in + 2 * n + h),
        "conv_w": mat(ssm_mod._CONV_K, d_in, std=0.5),
        "dt_bias": full(h, 0.0),
        "a_log": full(h, 0.0),
        "d_skip": full(h, 1.0),
        "norm": full(d_in, 0.0),
        "out_proj": mat(d_in, d),
    }


def init_params(
    cfg: ModelConfig,
    seed_or_generator: Union[int, torch.Generator],
    device: Union[None, str, torch.device] = None,
    *,
    masters: bool = False,
) -> Dict[str, Any]:
    """Random parameters with the JAX package's keys, shapes and scales,
    drawn on ``device`` (``None``: the card, raising without one) from a
    seeded ``torch.Generator``: :data:`BF16_WEIGHTS` in bf16 for serving,
    or every leaf in fp32 with ``masters`` (for training; the same draws).
    The draws differ from ``jax.random``'s; use :func:`params_from_jax` to
    compute what the JAX package computes. On ``device="meta"`` nothing is
    drawn: the leaves carry shapes and dtypes only."""
    _check_family(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":  # shapes and dtypes only: nothing is drawn
        gen = None
    elif isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))
    d, vp = cfg.d_model, cfg.padded_vocab
    wdt = torch.float32 if masters else COMPUTE_DTYPE
    if cfg.family == "zamba2":
        return zamba2.init_params(cfg, gen, dev, wdt)
    params: Dict[str, Any] = {"final_norm": torch.zeros(d, dtype=torch.float32, device=dev)}
    if cfg.family == "audio":  # no token embedding: one head per codebook
        params["lm_head"] = normal_init(gen, (d, cfg.num_codebooks * vp), 0.02,
                                        dtype=wdt, device=dev)
    else:
        params["embed"] = normal_init(gen, (vp, d), 0.02, dtype=wdt, device=dev)
        params["lm_head"] = normal_init(gen, (d, vp), 0.02, dtype=wdt, device=dev)
    if cfg.family in _TRANSFORMERS:
        L = cfg.num_layers
        params["layers"] = {
            "ln1": torch.zeros((L, d), dtype=torch.float32, device=dev),
            "ln2": torch.zeros((L, d), dtype=torch.float32, device=dev),
            **_attn_params(gen, cfg, dev, wdt, (L,)),
            **_ffn_params(gen, cfg, dev, wdt, (L,)),
        }
    elif cfg.family == "hybrid":
        params["mamba"] = _mamba_params(gen, cfg, dev, wdt)
        params["shared_attn"] = {
            "ln1": torch.zeros(d, dtype=torch.float32, device=dev),
            "ln2": torch.zeros(d, dtype=torch.float32, device=dev),
            **_attn_params(gen, cfg, dev, wdt),
            **_ffn_params(gen, cfg, dev, wdt),
        }
    else:
        params["layers"] = _rwkv_params(gen, cfg, cfg.num_layers, dev, wdt)
    return params


def params_from_jax(
    tree: Mapping[str, Any], device: Union[None, str, torch.device] = None, *,
    masters: bool = False,
) -> Dict[str, Any]:
    """The JAX package's parameter tree, its leaves given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's: same keys, the
    values as tensors on ``device``, :data:`BF16_WEIGHTS` cast to bf16, or,
    with ``masters``, every float leaf in fp32 (for training)."""
    dev = resolve_device(device)

    def conv(key: str, value: Any):
        if isinstance(value, Mapping):
            return {k: conv(k, v) for k, v in value.items()}
        arr = np.asarray(value)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)  # exact for the fp32 and bf16 leaves
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        return t.to(COMPUTE_DTYPE) if key in BF16_WEIGHTS and not masters else t

    return {k: conv(k, v) for k, v in tree.items()}


def _unstack(tree, i: int):
    """Entry ``i`` of the leading dim of every leaf of a (nested) dict."""
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _stack(trees: list):
    """The inverse of :func:`_unstack`: leaves stacked on a new leading dim."""
    return {
        k: _stack([t[k] for t in trees]) if isinstance(v, dict) else torch.stack([t[k] for t in trees])
        for k, v in trees[0].items()
    }


def _depth(tree) -> int:
    leaf = next(iter(tree.values()))
    return _depth(leaf) if isinstance(leaf, dict) else leaf.shape[0]


def _embed(params, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
    """The tokens' rows of the embedding, in bf16. On a mesh, a lookup on
    each rank's tokens (batch over dp) in the gathered table: the same
    local index and, in the backward, the same local scatter as off-mesh."""
    emb = params["embed"]
    idx = tokens.to(device=emb.device, dtype=torch.long)
    if not on_mesh(ctx):
        return emb[idx].to(COMPUTE_DTYPE)
    spec = batch_spec(ctx, idx.shape)
    return shard_map_compat(lambda e, i: e[i].to(COMPUTE_DTYPE), mesh=ctx.mesh,
                            in_specs=(P(None, None), spec), out_specs=P(*spec, None))(emb, idx)


def _logits(cfg: ModelConfig, params, x_last: torch.Tensor) -> torch.Tensor:
    """(B, D) -> fp32 (B, V); the product is rounded to bf16 before the
    fp32 cast, as in the JAX package."""
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return matmul(x_last, params["lm_head"]).float()


def _embed_step(cfg: ModelConfig, params, batch, ctx=None) -> torch.Tensor:
    """(B, S, D) bf16: audio's frame embeddings, else the tokens'
    embeddings. What a decode step takes."""
    if cfg.family == "audio":
        return batch["frame_embeds"].to(params["lm_head"].device, COMPUTE_DTYPE)
    return _embed(params, batch["tokens"], ctx)


def _embed_inputs(cfg: ModelConfig, params, batch, ctx=None):
    """Returns (hidden (B, S, D) bf16, prefix_len): :func:`_embed_step`'s,
    after vlm's patch embeddings for a prompt."""
    tok = _embed_step(cfg, params, batch, ctx)
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(tok.device, COMPUTE_DTYPE)
        return torch.cat([patches, tok], dim=1), cfg.num_patches
    return tok, 0


# ---------------------------------------------------------------------------
# Transformer blocks (the transformers' layers and Zamba2's shared block)
# ---------------------------------------------------------------------------


def _attn_qkv(x, p, cfg: ModelConfig, positions):
    """Pre-norm q, k, v with RoPE: (B,S,H,hd), (B,S,KV,hd), (B,S,KV,hd)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = matmul(a, p["wq"]).reshape(b, s, h, hd)
    k = matmul(a, p["wk"]).reshape(b, s, kv, hd)
    v = matmul(a, p["wv"]).reshape(b, s, kv, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _attn_block(x, p, cfg: ModelConfig, *, window, positions, prefix_len=0, train=False,
                ctx=None):
    """Returns (x + attention, (k, v)): the keys and values for the cache.
    ``train`` takes attention's differentiable route."""
    b, s, _ = x.shape
    q, k, v = constrain_qkv(*_attn_qkv(x, p, cfg, positions), ctx)
    o = blocked_attention(q, k, v, window=window, prefix_len=prefix_len, train=train, ctx=ctx)
    x = x + matmul(o.reshape(b, s, -1), p["wo"])
    return x, (k, v)


def _ffn_block(x, p, cfg: ModelConfig, ctx=None):
    a = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        y = moe_ffn(a, p, k=cfg.experts_per_token, capacity_factor=cfg.moe_capacity_factor,
                    ctx=ctx)
    else:
        y = dense_ffn(a, p["w_gate"], p["w_up"], p["w_down"])
    return x + y


def _decode_attn_layer(x, p, cfg: ModelConfig, kc, vc, cur_len: int, window: int, positions,
                       ctx=None):
    """One decode attention block against a (B,S,KV,hd) cache layer. Writes
    the token's k and v at ``cur_len`` into ``kc`` and ``vc`` in place: the
    caller passes a fresh copy."""
    b = x.shape[0]
    q, k, v = _attn_qkv(x, p, cfg, positions)
    kc[:, cur_len] = k[:, 0].to(kc.dtype)
    vc[:, cur_len] = v[:, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, cur_len + 1, window=window, ctx=ctx)
    return x + matmul(o.reshape(b, 1, -1), p["wo"])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept: the JAX package's ``jax.checkpoint(...,
    nothing_saveable)`` around each layer."""
    return checkpoint(fn, *args, use_reentrant=False)


def _transformer_layer(x, p, cfg: ModelConfig, window: int, positions, prefix_len: int,
                       ctx=None):
    x, _ = _attn_block(x, p, cfg, window=window, positions=positions, prefix_len=prefix_len,
                       train=True, ctx=ctx)
    return _ffn_block(x, p, cfg, ctx)


def _mamba_layer(x, p, cfg: ModelConfig, ctx=None):
    return x + ssm_mod.mamba2_block(rms_norm(x, p["ln"], cfg.norm_eps), p, cfg, train=True,
                                    analysis=_analysis(ctx), ctx=ctx)


def _hybrid_super_block(x, mp, shared, cfg: ModelConfig, positions, ctx=None):
    """Six Mamba2 layers, then the shared attention+MLP block."""
    for j in range(_depth(mp)):
        x = _mamba_layer(x, _unstack(mp, j), cfg, ctx)
    return _transformer_layer(x, shared, cfg, x.shape[1], positions, 0, ctx)


def _rwkv_layer(x, p, cfg: ModelConfig, ctx=None):
    x = x + ssm_mod.rwkv6_block(rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg, train=True,
                                analysis=_analysis(ctx), ctx=ctx)
    y, _ = ssm_mod.rwkv6_channel_mix(rms_norm(x, p["ln2"], cfg.norm_eps), p)
    return x + y


def _backbone(cfg: ModelConfig, params, x, *, positions, prefix_len: int, ctx=None):
    """Every layer of the stack on the training route, each recomputed in
    the backward pass, then the final norm."""
    if cfg.family in _TRANSFORMERS:
        for i, window in enumerate(cfg.layer_windows(x.shape[1])):
            layer = functools.partial(_transformer_layer, cfg=cfg, window=window,
                                      positions=positions, prefix_len=prefix_len, ctx=ctx)
            x = _remat(layer, x, _unstack(params["layers"], i))
    elif cfg.family == "hybrid":
        block = functools.partial(_hybrid_super_block, cfg=cfg, positions=positions, ctx=ctx)
        for sb in range(_depth(params["mamba"])):
            x = _remat(block, x, _unstack(params["mamba"], sb), params["shared_attn"])
    else:
        layer = functools.partial(_rwkv_layer, cfg=cfg, ctx=ctx)
        for i in range(_depth(params["layers"])):
            x = _remat(layer, x, _unstack(params["layers"], i))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward_train(cfg: ModelConfig, params, batch, ctx=None) -> torch.Tensor:
    """Mean token cross-entropy (fp32 scalar) of ``batch``: {"tokens",
    "labels"} (B, S); vlm also {"patch_embeds"} (its loss over the text
    positions only); audio {"frame_embeds": (B, S, D), "labels": (B, S,
    codebooks)}. Labels below 0 are not counted. Differentiable in
    ``params``; the kernels are not used (see the module docstring). On a
    mesh the loss is a plain scalar, the same on every rank, and a caller
    that differentiates it enters ``dist.sharding.replicate_plain(ctx)``
    around the backward pass, after this returns
    (``launch.steps.make_train_step`` does)."""
    _check_family(cfg)
    if cfg.family == "zamba2":
        raise NotImplementedError("the zamba2 family is served only: no training forward")
    with replicate_plain(ctx):
        x, prefix_len = _embed_inputs(cfg, params, batch, ctx)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = constrain_hidden(x, cfg, ctx)
        x = _backbone(cfg, params, x, positions=positions, prefix_len=prefix_len, ctx=ctx)
        logits = matmul(x, params["lm_head"])
        labels = batch["labels"].to(device=x.device, dtype=torch.long)
        if cfg.family == "audio":
            logits = logits.reshape(b, s, cfg.num_codebooks, cfg.padded_vocab)
            valid = None
        else:
            if cfg.family == "vlm":
                logits = logits[:, prefix_len:]  # loss over text positions only
            labels, valid = torch.clamp_min(labels, 0), labels >= 0
        if not on_mesh(ctx):
            return cross_entropy(logits, labels, valid=valid, vocab_size=cfg.vocab_size)
        return _mesh_loss(logits, labels, valid, cfg.vocab_size, ctx)


def _mesh_loss(logits, labels, valid, vocab_size: int, ctx) -> torch.Tensor:
    """:func:`cross_entropy` on a mesh: each rank sums its own tokens' NLL
    and counts them (``local_map``; the sums are ``Partial`` over the
    data-parallel axes), so no (B, S, V) tensor leaves its rank in the
    forward or the backward; the mean is a plain scalar on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if valid is None:
        valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    spec = batch_spec(ctx, labels.shape)
    dp_dims = {i for i, p in enumerate(placements(spec, ctx.mesh)) if isinstance(p, Shard)}
    sums = [Partial() if i in dp_dims else Replicate() for i in range(ctx.mesh.ndim)]

    def local(lg, lb, vd):
        v = vd.float()
        return (token_nll(lg, lb, vocab_size=vocab_size) * v).sum(), v.sum()

    in_pl = tuple(placements(batch_spec(ctx, t.shape), ctx.mesh) for t in (logits, labels, valid))
    total, count = local_map(local, out_placements=(sums, sums), in_placements=in_pl,
                             device_mesh=ctx.mesh, redistribute_inputs=True)(
        *(as_dtensor(t, ctx.mesh) for t in (logits, labels, valid)))
    return total.full_tensor() / torch.clamp_min(count.full_tensor(), 1.0)


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, *,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Any]:
    """Zero cache for ``max_len`` positions. A transformer's cache holds
    each layer's keys and values (L, B, max_len, KV, hd) bf16; an RWKV-6
    cache holds each layer's recurrence state and two token-shift carries,
    whatever the length; a Zamba2 cache holds each Mamba2 layer's state and
    conv carry under ``"mamba"`` (super-block, layer, ...), and the shared
    attention's keys and values at each of its applications (super-block,
    B, max_len, KV, hd); a ``zamba2`` cache likewise, with a KV cache for
    each use of its shared blocks (:func:`repro_torch.models.zamba2.init_cache`).
    ``device="meta"`` sizes it without memory."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "zamba2":
        return zamba2.init_cache(cfg, batch, max_len, dev)
    if cfg.family in _TRANSFORMERS:
        kv_shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
            "v": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
        }
    if cfg.family == "hybrid":
        nb, ae = cfg.num_layers // cfg.attn_every, cfg.attn_every
        mam = ssm_mod.mamba2_init_cache(cfg, batch, COMPUTE_DTYPE, device="meta")
        kv_shape = (nb, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {
            "mamba": {
                k: torch.zeros((nb, ae, *v.shape), dtype=v.dtype, device=dev)
                for k, v in mam.items()
            },
            "k": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
            "v": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
        }
    rw = ssm_mod.rwkv6_init_cache(cfg, batch, COMPUTE_DTYPE, device="meta")
    return {
        k: torch.zeros((cfg.num_layers, *v.shape), dtype=v.dtype, device=dev)
        for k, v in rw.items()
    }


def _rwkv_decode(cfg: ModelConfig, params, x, cache):
    news = []
    for i in range(_depth(params["layers"])):
        p, c = _unstack(params["layers"], i), _unstack(cache, i)
        y, c1 = ssm_mod.rwkv6_decode(rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg, c)
        x = x + y
        z, cm_prev = ssm_mod.rwkv6_channel_mix(
            rms_norm(x, p["ln2"], cfg.norm_eps), p, prev=c["cm_prev"].to(COMPUTE_DTYPE)
        )
        c1["cm_prev"] = cm_prev
        news.append(c1)
        x = x + z
    return x, _stack(news)


def _transformer_decode(cfg: ModelConfig, params, x, cache, cur_len: int, ctx=None):
    positions = torch.full((x.shape[0], 1), cur_len, dtype=torch.long, device=x.device)
    # every layer's window, a full one capped as the JAX package caps it
    windows = [min(w, 2**30) for w in cfg.layer_windows(10**9)]
    # the given cache is shared by every generate task of its prompt: the
    # token's keys and values go into a copy
    knew, vnew = cache["k"].clone(), cache["v"].clone()
    for i, window in enumerate(windows):
        p = _unstack(params["layers"], i)
        x = _decode_attn_layer(x, p, cfg, knew[i], vnew[i], cur_len, window, positions, ctx)
        x = _ffn_block(x, p, cfg, ctx)
    return x, {"k": knew, "v": vnew}


def _hybrid_decode(cfg: ModelConfig, params, x, cache, cur_len: int, ctx=None):
    shared = params["shared_attn"]
    positions = torch.full((x.shape[0], 1), cur_len, dtype=torch.long, device=x.device)
    # the given cache is shared by every generate task of its prompt: the
    # token's keys and values go into a copy
    knew, vnew = cache["k"].clone(), cache["v"].clone()
    supers = []
    for sb in range(_depth(params["mamba"])):
        mp, mc = _unstack(params["mamba"], sb), _unstack(cache["mamba"], sb)
        news = []
        for j in range(_depth(mp)):
            p = _unstack(mp, j)
            y, c1 = ssm_mod.mamba2_decode(
                rms_norm(x, p["ln"], cfg.norm_eps), p, cfg, _unstack(mc, j)
            )
            x = x + y
            news.append(c1)
        supers.append(_stack(news))
        x = _decode_attn_layer(x, shared, cfg, knew[sb], vnew[sb], cur_len, 2**30, positions,
                               ctx)
        x = _ffn_block(x, shared, cfg, ctx)
    return x, {"mamba": _stack(supers), "k": knew, "v": vnew}


def decode_attention_calls(cfg: ModelConfig) -> int:
    """The ``attention.decode_attention`` calls that one :func:`decode_step`
    makes: a ``zamba2``'s uses of its shared blocks, a hybrid's one a
    super-block, a transformer's one a layer, RWKV-6's none."""
    if cfg.family == "zamba2":
        return len(cfg.hybrid_layer_ids)
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers if cfg.family in _TRANSFORMERS else 0


def decode_step(cfg: ModelConfig, params, batch, cache, cur_len: int, ctx=None):
    """One token for every sequence at position ``cur_len``. ``batch``:
    {"tokens": (B, 1)}, or {"frame_embeds": (B, 1, D)} for audio. Returns
    (logits fp32 (B, V), audio's (B, codebooks * V), new cache); ``cache``
    is not modified."""
    _check_family(cfg)
    if cfg.family == "zamba2":
        _zamba2_off_mesh(ctx)
        return zamba2.decode_step(cfg, params, batch["tokens"], cache, int(cur_len))
    with replicate_plain(ctx):
        x = _embed_step(cfg, params, batch, ctx)
        if cfg.family in _TRANSFORMERS:
            x, cache = _transformer_decode(cfg, params, x, cache, int(cur_len), ctx)
        elif cfg.family == "hybrid":
            x, cache = _hybrid_decode(cfg, params, x, cache, int(cur_len), ctx)
        else:
            x, cache = _rwkv_decode(cfg, params, x, cache)
        return _logits(cfg, params, x[:, 0]), cache


class _Chained:
    """A generate's steps through :func:`decode_step`, which copies the
    cache it is given: the latest cache, each step's taken in its place."""

    def __init__(self, cfg: ModelConfig, params, cache) -> None:
        self.cfg, self.params, self.cache = cfg, params, cache

    def step(self, batch, cur_len: int) -> torch.Tensor:
        logits, self.cache = decode_step(self.cfg, self.params, batch, self.cache, cur_len)
        return logits


def decoder(cfg: ModelConfig, params, cache):
    """The decode steps of one generate from ``cache``, which is not
    modified (a prompt's cache is shared by every generate under it): an
    object whose ``step(batch, cur_len)`` takes ``batch`` as :func:`decode_step`
    does and returns its logits. It owns the buffers its steps write (a
    ``zamba2``'s, :class:`zamba2.Decoder`: two cache sets, a CUDA graph each on the card)."""
    _check_family(cfg)
    if cfg.family == "zamba2":
        return zamba2.Decoder(cfg, params, cache)
    return _Chained(cfg, params, cache)


def _rwkv_prefill(cfg: ModelConfig, params, x, ctx=None):
    states, tm_prev, cm_prev = [], [], []
    for i in range(_depth(params["layers"])):
        p = _unstack(params["layers"], i)
        a = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, state = ssm_mod.rwkv6_block(a, p, cfg, return_state=True, analysis=_analysis(ctx),
                                       ctx=ctx)
        x = x + y
        z, cm = ssm_mod.rwkv6_channel_mix(rms_norm(x, p["ln2"], cfg.norm_eps), p)
        states.append(state)
        tm_prev.append(a[:, -1])
        cm_prev.append(cm)
        x = x + z
    cache = {
        "state": torch.stack(states),
        "tm_prev": torch.stack(tm_prev),
        "cm_prev": torch.stack(cm_prev),
    }
    return x, cache


def _cache_zeros(shape, like: torch.Tensor) -> torch.Tensor:
    """bf16 zeros of ``shape``: a stacking dim, then ``like``'s dims with a
    longer sequence. On a mesh a DTensor laid out as ``like`` (the stacking
    dim replicated), each rank allocating only its shard."""
    if not hasattr(like, "placements"):
        return torch.zeros(shape, dtype=COMPUTE_DTYPE, device=like.device)
    from torch.distributed.tensor import DTensor, Shard

    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in like.placements]
    local = list(shape)
    for size, p in zip(like.device_mesh.shape, pl):
        if isinstance(p, Shard):
            local[p.dim] //= size
    zeros = torch.zeros(local, dtype=COMPUTE_DTYPE, device=like.to_local().device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(zeros, like.device_mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _transformer_prefill(cfg: ModelConfig, params, x, prefix_len: int, max_len: int,
                         ctx=None):
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    kv_shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads, cfg.head_dim)
    for i, window in enumerate(cfg.layer_windows(s)):
        p = _unstack(params["layers"], i)
        x, (k, v) = _attn_block(x, p, cfg, window=window, positions=positions,
                                prefix_len=prefix_len, ctx=ctx)
        x = _ffn_block(x, p, cfg, ctx)
        if i == 0:
            kc, vc = _cache_zeros(kv_shape, k), _cache_zeros(kv_shape, v)
        kc[i, :, :s] = k
        vc[i, :, :s] = v
    return x, {"k": kc, "v": vc}


def _hybrid_prefill(cfg: ModelConfig, params, x, max_len: int, ctx=None):
    shared = params["shared_attn"]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    supers, ks, vs = [], [], []
    for sb in range(_depth(params["mamba"])):
        mp = _unstack(params["mamba"], sb)
        caches = []
        for j in range(_depth(mp)):
            p = _unstack(mp, j)
            y, c = ssm_mod.mamba2_block(rms_norm(x, p["ln"], cfg.norm_eps), p, cfg,
                                        return_cache=True, analysis=_analysis(ctx), ctx=ctx)
            x = x + y
            caches.append(c)
        x, (k, v) = _attn_block(x, shared, cfg, window=s, positions=positions, ctx=ctx)
        x = _ffn_block(x, shared, cfg, ctx)
        supers.append(_stack(caches))
        ks.append(k)
        vs.append(v)
    kv_shape = (len(ks), b, max_len, cfg.num_kv_heads, cfg.head_dim)
    kc, vc = _cache_zeros(kv_shape, ks[0]), _cache_zeros(kv_shape, vs[0])
    kc[:, :, :s] = torch.stack(ks)
    vc[:, :, :s] = torch.stack(vs)
    return x, {"mamba": _stack(supers), "k": kc, "v": vc}


def prefill(cfg: ModelConfig, params, batch, max_len: int, ctx=None):
    """Run the prompt; returns (last-position logits fp32 (B, V), audio's
    (B, codebooks * V), filled cache, length). ``batch``: {"tokens": (B,
    S)}; vlm also {"patch_embeds": (B, num_patches, D)}, put before the
    tokens; audio {"frame_embeds": (B, S, D)} only."""
    _check_family(cfg)
    if cfg.family == "zamba2":
        _zamba2_off_mesh(ctx)
        return zamba2.prefill(cfg, params, batch["tokens"], max_len)
    with replicate_plain(ctx):
        x, prefix_len = _embed_inputs(cfg, params, batch, ctx)
        x = constrain_hidden(x, cfg, ctx)
        if cfg.family in _TRANSFORMERS:
            x, cache = _transformer_prefill(cfg, params, x, prefix_len, max_len, ctx)
        elif cfg.family == "hybrid":
            x, cache = _hybrid_prefill(cfg, params, x, max_len, ctx)
        else:
            x, cache = _rwkv_prefill(cfg, params, x, ctx)
        return _logits(cfg, params, x[:, -1]), cache, x.shape[1]
