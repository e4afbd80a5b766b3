"""The plain reference of IBM's Granite 4.0-H (granite-4.0-h-small's
layout, ``model_type`` granitemoehybrid): the forward pass of one sequence
in float32 PyTorch, with no cache, no batching and no kernel of the
program. It reads the configuration in the published ``config.json``'s
keys and takes the program's parameters (a dict of tensors, the program's
keys), upcast to float32 one layer, and one expert, at a time, so that it
fits beside them on the card: the whole model in float32 would be 129 GB.

With ``x = embedding_multiplier · E[tokens]`` and ``r`` the residual
multiplier, every layer ℓ, as ``transformers``' ``GraniteMoeHybridDecoderLayer``:

    x ← x + r · Mixer_ℓ(RMSNorm(x))
    u = RMSNorm(x)
    x ← x + r · (Σ_{e in top k} g_e · SwiGLU_e(u) + SwiGLU_shared(u)),
    g = softmax(top-k router logits)

The mixer is ``layer_types[ℓ]``'s. Attention: q, k and v projections with
no bias and no positional encoding (``position_embedding_type`` nope),
``num_key_value_heads`` kv heads each shared by a group of q heads, causal,
logits scaled by ``attention_multiplier``, then the o projection. Mamba2:
``in_proj`` to z, xBC and dt; a depthwise causal conv of 4 taps with bias,
then SiLU, over xBC; dt = softplus(dt + dt_bias), A = −exp(A_log); the scan
h_t = exp(dt_t·A)·h_{t−1} + dt_t·B_t ⊗ x_t, y_t = C_t·h_t + D·x_t, with B
and C shared by the heads of each group; y·SiLU(z) normalised over each
group, then ``out_proj``. The experts are dropless: each token takes each of
its top k experts, whatever their load (each expert computed over the
tokens that chose it). Then the final RMSNorm and the LM head, tied to the
embedding, the logits divided by ``logits_scaling``.

Departures from the published model, shared with the program: every
RMSNorm scales by ``1 + weight`` (weights stored as offsets from 1), and
the scan runs in chunks of 64 positions, which is the recurrence exactly
in real arithmetic. ``precision="float8_e4m3"`` is the control: every
matrix product's inputs (the projections, the router, the experts, the LM
head and attention's two products) are rounded to float8 e4m3, each
tensor scaled by its largest magnitude to e4m3's largest, 448; the rest
stays float32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "float8_e4m3")
_E4M3_MAX = 448.0
_CHUNK = 64


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return t
    scale = _E4M3_MAX / t.abs().amax().clamp_min(1e-30)
    return (t * scale).clamp(-_E4M3_MAX, _E4M3_MAX).to(torch.float8_e4m3fn).float() / scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return _round(a, precision) @ _round(b, precision)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _attention(u, p: Dict[str, torch.Tensor], cfg: Mapping[str, Any], precision: str):
    """Causal grouped-query attention with no positional encoding: (S, D)
    -> (S, D)."""
    s = u.shape[0]
    heads, kv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    hd = int(cfg["hidden_size"]) // heads
    q = _mm(u, p["wq"], precision).reshape(s, heads, hd).transpose(0, 1)  # (H, S, hd)
    k, v = (_mm(u, p[w], precision).reshape(s, kv, hd).transpose(0, 1)
            .repeat_interleave(heads // kv, dim=0) for w in ("wk", "wv"))
    logits = _mm(q, k.transpose(1, 2), precision) * float(cfg["attention_multiplier"])
    causal = torch.ones(s, s, dtype=torch.bool, device=u.device).tril()
    prob = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm(prob, v, precision).transpose(0, 1).reshape(s, heads * hd)
    return _mm(o, p["wo"], precision)


def _scan(x, dt, a, b, c):
    """The recurrence, exactly, in chunks of ``_CHUNK`` positions. x (S,
    H, P), dt (S, H), a (H,) = −exp(A_log), b and c (S, H, N) -> y (S, H, P)
    without the D skip."""
    s, h, p = x.shape
    n, q = b.shape[-1], _CHUNK
    pad = -s % q
    x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) for t in (x, dt, b, c))
    nc = (s + pad) // q
    xdt = (x * dt[..., None]).reshape(nc, q, h, p)
    b, c = b.reshape(nc, q, h, n), c.reshape(nc, q, h, n)
    cum = (dt * a).reshape(nc, q, h).cumsum(1)  # log decay from the chunk's start
    lower = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    diff = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(~lower, float("-inf"))
    scores = torch.exp(diff) * torch.einsum("cthn,cshn->ctsh", c, b)
    y = torch.einsum("ctsh,cshp->cthp", scores, xdt)
    to_end = torch.exp(cum[:, -1:, :] - cum)  # (nc, q, h)
    states = torch.einsum("cshn,cshp->chnp", b * to_end[..., None], xdt)
    carried = torch.zeros_like(states)
    run = torch.zeros_like(states[0])
    for k in range(nc):
        carried[k] = run
        run = torch.exp(cum[k, -1])[:, None, None] * run + states[k]
    y = y + torch.einsum("cthn,chnp->cthp", c, carried) * torch.exp(cum)[..., None]
    return y.reshape(nc * q, h, p)[:s]


def _mamba(x, p: Dict[str, torch.Tensor], cfg: Mapping[str, Any], precision: str):
    s = x.shape[0]
    d_in = int(cfg["mamba_expand"]) * int(cfg["hidden_size"])
    pdim, n, g = int(cfg["mamba_d_head"]), int(cfg["mamba_d_state"]), int(cfg["mamba_n_groups"])
    h = d_in // pdim
    z, xbc, dt = torch.split(_mm(x, p["in_proj"], precision), [d_in, d_in + 2 * g * n, h], -1)
    w = p["conv_w"]  # (K, C): tap i multiplies the input K-1-i positions back
    kw = w.shape[0]
    padded = F.pad(xbc, (0, 0, kw - 1, 0))
    xbc = F.silu(sum(padded[i:i + s] * w[i] for i in range(kw)) + p["conv_b"])
    xs, bg, cg = torch.split(xbc, [d_in, g * n, g * n], -1)
    dt = F.softplus(dt + p["dt_bias"])
    heads = lambda t: t.reshape(s, g, n).repeat_interleave(h // g, dim=1)  # noqa: E731
    xs = xs.reshape(s, h, pdim)
    y = _scan(xs, dt, -torch.exp(p["a_log"]), heads(bg), heads(cg))
    y = (y + p["d_skip"][:, None] * xs).reshape(s, d_in) * F.silu(z)
    y = y.reshape(s, g, -1)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + float(cfg["rms_norm_eps"]))
    return _mm(y.reshape(s, d_in) * (1.0 + p["norm"]), p["out_proj"], precision)


def _swiglu(u, w_gate, w_up, w_down, precision: str):
    gate, up = _mm(u, w_gate.float(), precision), _mm(u, w_up.float(), precision)
    return _mm(F.silu(gate) * up, w_down.float(), precision)


def _moe(u, p: Mapping[str, torch.Tensor], layer: int, cfg: Mapping[str, Any], precision: str):
    """The routed experts, dropless, and the shared expert: (S, D) -> (S, D)."""
    k = int(cfg["num_experts_per_tok"])
    logits = _mm(u, p["router"][layer].float(), precision)
    top, experts = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = _swiglu(u, p["shared_gate"][layer], p["shared_up"][layer], p["shared_down"][layer],
                  precision)
    for e in torch.unique(experts).tolist():
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        y = _swiglu(u[rows], p["w_gate"][layer, e], p["w_up"][layer, e], p["w_down"][layer, e],
                    precision)
        out.index_add_(0, rows, gates[rows, slot][:, None] * y)
    return out


def _f32(tree: Mapping[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i].float() for k, v in tree.items()}


@torch.no_grad()
def logits(cfg: Mapping[str, Any], params: Mapping[str, Any], tokens: torch.Tensor, last: int,
           precision: str = "float32") -> torch.Tensor:
    """Float32 logits (last, rows of the embedding) of the last ``last``
    positions of one sequence ``tokens`` (S,), on the parameters' device."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb = params["embed"]
    eps, r = float(cfg["rms_norm_eps"]), float(cfg["residual_multiplier"])
    x = emb[tokens.to(emb.device, torch.long)].float() * float(cfg["embedding_multiplier"])
    seen = {"mamba": 0, "attention": 0}
    for layer, kind in enumerate(cfg["layer_types"]):
        u = _rms(x, params["ln1"][layer].float(), eps)
        if kind == "attention":
            y = _attention(u, _f32(params["attn"], seen[kind]), cfg, precision)
        else:
            y = _mamba(u, _f32(params["mamba"], seen[kind]), cfg, precision)
        seen[kind] += 1
        x = x + r * y
        x = x + r * _moe(_rms(x, params["ln2"][layer].float(), eps), params["moe"], layer, cfg,
                         precision)
    xl = _rms(x[-last:], params["final_norm"].float(), eps)
    return _mm(xl, emb.float().t(), precision) / float(cfg["logits_scaling"])
