"""Zyphra's Zamba2 (the ``zamba2`` family: :class:`repro_torch.configs.Zamba2Config`,
``configs/zamba2_7b.py``): parameters, cache, prefill and decode, reached
through :mod:`repro_torch.models.model`'s entry points.

With ``x_emb`` the embedding output and ``x`` the hidden stream (``x =
x_emb`` at the start), every layer ℓ computes

    x ← x + Mamba2_ℓ(RMSNorm(x + t_ℓ)),

with ``t_ℓ = 0`` except at the j-th of ``hybrid_layer_ids``, where shared
block ``j mod num_mem_blocks`` runs with use j's own adapter and linear:

    u = RMSNorm(concat(x, x_emb))                       (2·d_model wide)
    a = o_proj(Attn(RoPE(q(u)), RoPE(k(u)), v(u)))      (causal, scale (hd/2)^-½)
    m = RMSNorm(a);  g, w = split(W_gu·m + B_j(A_j·m))
    t_ℓ = L_j(W_down(gelu(g) ⊙ w))

The block has no residual of its own: its output enters that layer's
Mamba2 input only. Mamba2 is Zyphra's (:func:`repro_torch.models.ssm.mamba2_grouped_block`).
Then the final RMSNorm and the LM head, tied to the embedding.

Prefill runs the ``ssm_scan`` kernel in each layer and the tensor-core
``flash_attention`` kernel at each use on the card; decode updates each
Mamba2 state in O(1) and attends against each use's own KV cache, a
generate's steps replayed as CUDA graphs on the card (:class:`Decoder`). Norms
scale by ``1 + weight``, as everywhere in the port. Matrices are held in
bf16, norms, biases, decays and skips in fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Zamba2Config
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import blocked_attention, decode_attention
from repro_torch.models.layers import COMPUTE_DTYPE, matmul, normal_init

__all__ = ["init_params", "init_cache", "prefill", "decode_step", "Decoder"]

# init scales of the random weights: logits of std about 3 through the
# tied head; the final norm's scale drawn around 0 (N(0, 1)), or the tied
# head would give each position's own token a logit of about d·EMBED_STD²
# over the hidden stream's RMS and every step would repeat its input;
# residual branches of the embedding's size, so that the concatenated
# embedding still weighs in the shared blocks' input; every adapter factor
# nonzero
EMBED_STD = 0.05
BRANCH_GAIN = 0.05  # Mamba2 out-projection: each layer adds about this per channel
USE_GAIN = 0.2  # each use's linear
ADAPTER_GAIN = 0.5
DT_MIN, DT_MAX = 1e-3, 1e-1  # Mamba2's time-step range (the published config's)


def _draw(gen, lead: int, shape, std: Optional[float], dtype, dev) -> torch.Tensor:
    """``lead`` stacked normal draws of ``shape``, each drawn in fp32 and
    stored as ``dtype`` one at a time (the stack is never held in fp32)."""
    out = torch.empty((lead, *shape), dtype=dtype, device=dev)
    if gen is not None:
        for i in range(lead):
            out[i] = normal_init(gen, tuple(shape), std, dtype=dtype, device=dev)
    return out


def init_params(cfg: Zamba2Config, gen: Optional[torch.Generator], dev: torch.device,
                wdt: torch.dtype) -> Dict[str, Any]:
    """Random parameters from ``gen`` (None on the meta device). Keys:
    ``embed`` (V, D), ``final_norm``; ``mamba``, each layer's, stacked;
    ``blocks``, each shared block's; ``uses``, each hybrid use's adapter
    factors and linear."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    d_in, h, conv = cfg.ssm_expand * d, cfg.ssm_heads, cfg.ssm_conv_dim
    L, nb, nu = cfg.num_layers, cfg.num_mem_blocks, len(cfg.hybrid_layer_ids)
    attn = cfg.num_heads * cfg.head_dim
    f32 = torch.float32

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    def mat(lead, *shape, std=None, dtype=wdt):
        return _draw(gen, lead, shape, std, dtype, dev)

    if gen is None:
        dt_bias, a_log = torch.empty((L, h), device=dev), torch.empty((L, h), device=dev)
    else:
        # dt log-uniform in [DT_MIN, DT_MAX] through softplus's inverse; A = -(1..H)
        u = torch.rand((L, h), generator=gen, device=dev)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        dt_bias = dt + torch.log(-torch.expm1(-dt))
        a_log = torch.log(torch.arange(1, h + 1, dtype=f32, device=dev)).expand(L, h).clone()
    return {
        "embed": normal_init(gen, (cfg.padded_vocab, d), EMBED_STD, dtype=wdt, device=dev)
        if gen is not None else torch.empty((cfg.padded_vocab, d), dtype=wdt, device=dev),
        "final_norm": normal_init(gen, (d,), 1.0, device=dev) - 1.0
        if gen is not None else zeros(d),
        "mamba": {
            "ln": zeros(L, d),
            "in_proj": mat(L, d, d_in + conv + h),
            "conv_w": mat(L, ssm_mod._CONV_K, conv, std=0.5),
            "conv_b": mat(L, conv, std=0.1, dtype=f32),
            "dt_bias": dt_bias,
            "a_log": a_log,
            "d_skip": torch.ones((L, h), dtype=f32, device=dev),
            "norm": zeros(L, d_in),
            "out_proj": mat(L, d_in, d, std=BRANCH_GAIN / math.sqrt(d_in)),
        },
        "blocks": {
            "ln1": zeros(nb, cfg.attn_width),
            "wq": mat(nb, cfg.attn_width, attn),
            "wk": mat(nb, cfg.attn_width, attn),
            "wv": mat(nb, cfg.attn_width, attn),
            "wo": mat(nb, attn, d),
            "ln2": zeros(nb, d),
            "w_gate_up": mat(nb, d, 2 * f),
            "w_down": mat(nb, f, d),
        },
        "uses": {
            "adapter_a": mat(nu, d, r),
            "adapter_b": mat(nu, r, 2 * f, std=ADAPTER_GAIN / math.sqrt(r)),
            "linear": mat(nu, d, d, std=USE_GAIN / math.sqrt(d)),
        },
    }


def init_cache(cfg: Zamba2Config, batch: int, max_len: int, dev: torch.device) -> Dict[str, Any]:
    """Zeros: each Mamba2 layer's state and conv carry under ``"mamba"``
    (layer, ...), and each hybrid use's keys and values (use, B, max_len,
    heads, head_dim) bf16 under ``"k"`` and ``"v"``: two kinds of state side
    by side, one KV cache for each use of the two shared weight sets."""
    mam = ssm_mod.mamba2_grouped_init_cache(cfg, batch, COMPUTE_DTYPE, device="meta")
    kv_shape = (len(cfg.hybrid_layer_ids), batch, max_len, cfg.num_heads, cfg.head_dim)
    return {
        "mamba": {k: torch.zeros((cfg.num_layers, *v.shape), dtype=v.dtype, device=dev)
                  for k, v in mam.items()},
        "k": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
        "v": torch.zeros(kv_shape, dtype=COMPUTE_DTYPE, device=dev),
    }


def _layer(tree: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in tree.items()}


def _uses(cfg: Zamba2Config) -> Dict[int, int]:
    """Layer id -> its use number j (shared block j mod num_mem_blocks)."""
    return {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 scaled by 1 + ``w``, in x's dtype: the port's
    ``layers.rms_norm``, in PyTorch's one fused operation (decoding is
    bound by launches)."""
    return F.rms_norm(x.float(), (x.shape[-1],), 1.0 + w, eps).to(x.dtype)


def _qkv(x, x_emb, bp, cfg: Zamba2Config, positions):
    b, s, _ = x.shape
    u = _rms(torch.cat([x, x_emb], dim=-1), bp["ln1"], cfg.norm_eps)
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    q = _rope(matmul(u, bp["wq"]).reshape(shape), positions, cfg.rope_theta)
    k = _rope(matmul(u, bp["wk"]).reshape(shape), positions, cfg.rope_theta)
    return q, k, matmul(u, bp["wv"]).reshape(shape)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """``layers.apply_rope`` with its frequencies computed on x's device
    (no copy from the host: a decode step is captured as a CUDA graph).
    x: (B, S, H, D); positions (B, S)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _mlp(o, bp, up, cfg: Zamba2Config):
    """The block's tail from the attention output (B, S, heads·hd): o_proj,
    RMSNorm, the gelu MLP with use j's adapter on gate/up, use j's linear."""
    m = _rms(matmul(o.reshape(*o.shape[:2], -1), bp["wo"]), bp["ln2"], cfg.norm_eps)
    gu = matmul(m, bp["w_gate_up"]) + matmul(matmul(m, up["adapter_a"]), up["adapter_b"])
    g, w = gu.chunk(2, dim=-1)
    hidden = (F.gelu(g.float()) * w.float()).to(COMPUTE_DTYPE)
    return matmul(matmul(hidden, bp["w_down"]), up["linear"])


def _mamba_in(x, t, p, cfg: Zamba2Config):
    return _rms(x if t is None else x + t, p["ln"], cfg.norm_eps)


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb[tokens.to(device=emb.device, dtype=torch.long)].to(COMPUTE_DTYPE)


def _logits(cfg: Zamba2Config, params, x_last: torch.Tensor) -> torch.Tensor:
    """(B, D) -> fp32 (B, V) through the head tied to the embedding."""
    return matmul(_rms(x_last, params["final_norm"], cfg.norm_eps), params["embed"].t()).float()


def prefill(cfg: Zamba2Config, params, tokens: torch.Tensor, max_len: int):
    """Returns (last-position logits fp32 (B, V), filled cache, length)."""
    x_emb = _embed(params, tokens)
    b, s, _ = x_emb.shape
    positions = torch.arange(s, device=x_emb.device).expand(b, s)
    cache = init_cache(cfg, b, max_len, x_emb.device)
    uses, x = _uses(cfg), x_emb
    for layer in range(cfg.num_layers):
        t = None
        if layer in uses:
            j = uses[layer]
            bp = _layer(params["blocks"], j % cfg.num_mem_blocks)
            q, k, v = _qkv(x, x_emb, bp, cfg, positions)
            o = blocked_attention(q, k, v, window=s, scale=cfg.attn_scale)
            t = _mlp(o, bp, _layer(params["uses"], j), cfg)
            cache["k"][j, :, :s] = k
            cache["v"][j, :, :s] = v
            del q, k, v, o
        p = _layer(params["mamba"], layer)
        y, c = ssm_mod.mamba2_grouped_block(_mamba_in(x, t, p, cfg), p, cfg, return_cache=True)
        x = x + y
        cache["mamba"]["state"][layer] = c["state"]
        cache["mamba"]["conv"][layer] = c["conv"]
    return _logits(cfg, params, x[:, -1]), cache, s


def _step(cfg: Zamba2Config, params, tokens: torch.Tensor, pos: torch.Tensor, cache):
    """One decode step in place: the token (B, 1) at position ``pos`` (a
    0-d long tensor on the device) writes its keys and values at ``pos`` of
    each use's KV cache and updates every Mamba2 state and conv carry of
    ``cache``; returns the logits fp32 (B, V). Reads no host value, so that
    it can be captured as a CUDA graph."""
    x_emb = _embed(params, tokens)
    positions = pos.expand(x_emb.shape[0], 1)
    uses, x = _uses(cfg), x_emb
    for layer in range(cfg.num_layers):
        t = None
        if layer in uses:
            j = uses[layer]
            bp = _layer(params["blocks"], j % cfg.num_mem_blocks)
            q, k, v = _qkv(x, x_emb, bp, cfg, positions)
            cache["k"][j].index_copy_(1, pos.view(1), k)
            cache["v"][j].index_copy_(1, pos.view(1), v)
            o = decode_attention(q, cache["k"][j], cache["v"][j], pos + 1, window=2**30,
                                 scale=cfg.attn_scale)
            t = _mlp(o, bp, _layer(params["uses"], j), cfg)
        p, c = _layer(params["mamba"], layer), _layer(cache["mamba"], layer)
        x = x + ssm_mod.mamba2_grouped_decode(_mamba_in(x, t, p, cfg), p, cfg, c, c)
    return _logits(cfg, params, x[:, 0])


def _copy_cache(dst, src) -> None:
    for name in ("k", "v"):
        dst[name].copy_(src[name])
    for name in ("state", "conv"):
        dst["mamba"][name].copy_(src["mamba"][name])


class Decoder:
    """The decode steps of one generate from a prompt's ``cache``, which is
    not modified: two sets of cache buffers taken in turn, and on the card a
    CUDA graph of :func:`_step` on each, captured when the decoder is made:
    a step is about 4,400 device operations, which issued one by one from
    Python took 134 ms against the card's 86 (NVIDIA H100). A step copies
    its input (the prompt's cache, then the set written last) into the
    other set and runs there in place. The capture is thread-local, so that
    other workers' threads may launch meanwhile."""

    def __init__(self, cfg: Zamba2Config, params, cache) -> None:
        dev = cache["k"].device
        self.sets = [init_cache(cfg, cache["k"].shape[1], cache["k"].shape[2], dev) for _ in (0, 1)]
        self.tokens = torch.zeros((cache["k"].shape[1], 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.cfg, self.params, self.cache = cfg, params, cache
        self.last: Optional[int] = None  # the set written last
        self.graphs: list = [None, None]
        self.logits: list = [None, None]
        if dev.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # a first run outside the capture (cuBLAS handles)
            _step(self.cfg, self.params, self.tokens, self.pos, self.sets[0])
        torch.cuda.current_stream().wait_stream(side)
        pool = None
        for i, buffers in enumerate(self.sets):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                self.logits[i] = _step(self.cfg, self.params, self.tokens, self.pos, buffers)
            self.graphs[i], pool = graph, graph.pool()

    def step(self, batch, cur_len: int) -> torch.Tensor:
        """Logits fp32 (B, V) of the token ``batch["tokens"]`` (B, 1) at ``cur_len``."""
        i = self.last = 1 if self.last == 0 else 0
        _copy_cache(self.sets[i], self.cache)
        self.cache = self.sets[i]  # the next step's input
        self.tokens.copy_(batch["tokens"])
        self.pos.fill_(int(cur_len))
        if self.graphs[i] is None:
            return _step(self.cfg, self.params, self.tokens, self.pos, self.sets[i])
        self.graphs[i].replay()
        return self.logits[i].clone()  # 1 MB: the caller may keep it


def decode_step(cfg: Zamba2Config, params, tokens: torch.Tensor, cache, cur_len: int):
    """One token (B, 1) at position ``cur_len``, run eagerly; returns
    (logits fp32 (B, V), new cache): a fresh set shaped by
    :func:`init_cache`, ``cache`` copied into it and the step run there.
    ``cache`` is not modified."""
    out = init_cache(cfg, cache["k"].shape[1], cache["k"].shape[2], cache["k"].device)
    _copy_cache(out, cache)
    pos = torch.tensor(int(cur_len), dtype=torch.long, device=out["k"].device)
    return _step(cfg, params, tokens, pos, out), out
