"""The plain reference of Zyphra's Zamba2 (Zamba2-7B-Instruct's layout):
the forward pass of one sequence in float32 PyTorch, with no cache, no
batching and no kernel of the program. It reads the configuration in the
published ``config.json``'s keys and takes the program's parameters (a
dict of tensors, the program's keys; upcast to float32 one layer at a
time, so that it fits beside them on the card).

With ``x_emb`` the embedding of the tokens and ``x = x_emb``, every layer ℓ:

    x ← x + Mamba2_ℓ(RMSNorm(x + t_ℓ)),

``t_ℓ = 0`` except at the j-th hybrid layer id, where shared block
``j mod num_mem_blocks`` gives, with use j's adapter ``(A_j, B_j)`` and
linear ``L_j``:

    u = RMSNorm(concat(x, x_emb))
    a = o_proj(Attn(RoPE(q(u)), RoPE(k(u)), v(u)))   causal, logits scaled
                                                     by (head_dim / 2) ** -0.5
    m = RMSNorm(a);  g, w = split(W_gu·m + B_j(A_j·m))
    t_ℓ = L_j(W_down(gelu(g) ⊙ w))

as ``transformers``' ``Zamba2HybridLayer`` computes it (its
``Zamba2Attention`` scales by ``(head_dim / 2) ** -0.5``). Mamba2 as
published: ``in_proj`` to z, xBC and dt; a depthwise causal conv of 4 taps
with bias, then SiLU, over xBC; dt = softplus(dt + dt_bias), A =
−exp(A_log); the scan h_t = exp(dt_t·A)·h_{t−1} + dt_t·B_t ⊗ x_t, y_t =
C_t·h_t + D·x_t, with B and C shared by the heads of each group; y·SiLU(z)
normalised over each group (``RMSNormGated``), then ``out_proj``. Then the
final RMSNorm and the LM head, tied to the embedding.

Departures from the published model, shared with the program: every
RMSNorm scales by ``1 + weight`` (weights stored as offsets from 1), and
the scan runs in chunks of 64 positions, which is the recurrence exactly
in real arithmetic. ``precision="float8_e4m3"`` is the control: every
matrix product's inputs (the projections, the adapters, the LM head and
attention's two products) are rounded to float8 e4m3, each tensor scaled
by its largest magnitude to e4m3's largest, 448; the rest stays float32.
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


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), positions 0..S-1; rotate-half pairs (i, i + D/2)."""
    s, d = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, scale: float, precision: str) -> torch.Tensor:
    """Causal multi-head attention over (S, H, D) -> (S, H·D)."""
    s = q.shape[0]
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))  # (H, S, D)
    logits = _mm(q, k.transpose(1, 2), precision) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    return _mm(p, v, precision).transpose(0, 1).reshape(s, -1)


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
    pdim, n, g = int(cfg["mamba_headdim"]), int(cfg["mamba_d_state"]), int(cfg["mamba_ngroups"])
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


def _shared(x, x_emb, bp, up, cfg: Mapping[str, Any], precision: str):
    s, eps = x.shape[0], float(cfg["rms_norm_eps"])
    heads, hd = int(cfg["num_attention_heads"]), int(cfg["attention_head_dim"])
    u = _rms(torch.cat([x, x_emb], -1), bp["ln1"], eps)
    q, k, v = (_mm(u, bp[w], precision).reshape(s, heads, hd) for w in ("wq", "wk", "wv"))
    theta = float(cfg["rope_theta"])
    o = _attention(_rope(q, theta), _rope(k, theta), v, (hd / 2) ** -0.5, precision)
    m = _rms(_mm(o, bp["wo"], precision), bp["ln2"], eps)
    gu = _mm(m, bp["w_gate_up"], precision) + _mm(_mm(m, up["adapter_a"], precision),
                                                  up["adapter_b"], precision)
    gate, up_ = gu.chunk(2, -1)
    return _mm(_mm(F.gelu(gate) * up_, bp["w_down"], precision), up["linear"], precision)


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
    eps = float(cfg["rms_norm_eps"])
    x_emb = emb[tokens.to(emb.device, torch.long)].float()
    x = x_emb
    uses = {int(layer): j for j, layer in enumerate(cfg["hybrid_layer_ids"])}
    for layer in range(int(cfg["num_hidden_layers"])):
        xin = x
        if layer in uses:
            j = uses[layer]
            t = _shared(x, x_emb, _f32(params["blocks"], j % int(cfg["num_mem_blocks"])),
                        _f32(params["uses"], j), cfg, precision)
            xin = x + t
        p = _f32(params["mamba"], layer)
        x = x + _mamba(_rms(xin, p["ln"], eps), p, cfg, precision)
    xl = _rms(x[-last:], params["final_norm"].float(), eps)
    return _mm(xl, emb.float().t(), precision)

