"""State-space blocks: Mamba2 (SSD), in the JAX package's layout and in
Zyphra's published one (``mamba2_grouped_*``: B and C in groups, the conv
over x, B and C with a bias, the gated RMSNorm a group), and RWKV-6
(Finch) time mixing and channel mixing.

Both reduce to the diagonal-gated linear recurrence of
:func:`repro_torch.kernels.ops.ssm_scan`:

    h_t = a_t ⊙ h_{t-1} + b_t ⊗ x_t ;   y_t = h_tᵀ c_t

Mamba2 has a scalar decay per head (``a`` of shape (B, S, H), which the
kernel reads with a zero stride over the state dim). RWKV-6 has a
per-channel, data-dependent decay ``w`` and the current-token bonus ``u``
added at readout, as in the JAX package (decay applied at the consuming
step). Prefill runs the chunked scan (the CUDA kernel on the card);
training (``train=True``) runs the chunked scan's plain version on either
device, which autograd differentiates, as the JAX package's training does
off the TPU; decode updates the state directly, O(1) a token, with plain
tensor code. On a mesh (``ctx``) the scan runs on each rank's batch shard
through ``local_map`` (:func:`_scan`), so the kernel sees local tensors;
``analysis`` swaps in the scan's shape-preserving stub (the dry-run).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import batch_spec, on_mesh, shard_map_compat
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.layers import COMPUTE_DTYPE, matmul, rms_norm

__all__ = [
    "mamba2_block",
    "mamba2_decode",
    "mamba2_grouped_block",
    "mamba2_grouped_decode",
    "mamba2_grouped_init_cache",
    "mamba2_init_cache",
    "mamba2_scan_inputs",
    "rwkv6_block",
    "rwkv6_channel_mix",
    "rwkv6_decode",
    "rwkv6_init_cache",
]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

_CONV_K = 4


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prev: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel _CONV_K, then SiLU. x: (B, S, C); w:
    (K, C); ``bias`` (C,), added in fp32 before the SiLU. ``prev``: (B,
    K-1, C) carry-in state. Returns (y, new_prev). The taps are multiplied
    and summed in x's dtype, one rounding an operation."""
    b, s, c = x.shape
    if prev is None:
        prev = torch.zeros((b, _CONV_K - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)  # (B, S+K-1, C)
    y = xp[:, 0:s] * w[0]
    for i in range(1, _CONV_K):
        y = y + xp[:, i : i + s] * w[i]
    y = y.float() if bias is None else y.float() + bias.float()
    return F.silu(y).to(x.dtype), xp[:, -(_CONV_K - 1):]


def _mamba_project(x, p, cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    zxbcdt = matmul(x, p["in_proj"])
    z, xs, bc, cc, dt = torch.split(zxbcdt, [d_in, d_in, n, n, cfg.ssm_heads], dim=-1)
    # softplus as jax.nn.softplus: log(1 + e^x) without a cut-off
    dt = torch.logaddexp(dt.float() + p["dt_bias"].float(), torch.zeros((), device=x.device))
    a = torch.exp(-dt * torch.exp(p["a_log"].float()))  # (B,S,H) decay
    return z, xs, bc, cc, dt, a


def _mamba_readout(y, xh, z, p, cfg):
    """Skip term, gate, norm and out-proj, shared by prefill and decode.
    y: (B, S, H, P) scan output; xh: (B, S, H, P) conv output."""
    b, s = y.shape[:2]
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, -1).to(COMPUTE_DTYPE)
    y = y * F.silu(z.float()).to(COMPUTE_DTYPE)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return matmul(y, p["out_proj"])


def mamba2_scan_inputs(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg):
    """The prefill's projections and conv: returns the scan's inputs
    ``(xh, a, b, c)`` as :func:`mamba2_block` passes them (c broadcast over
    the heads without a copy), the gate ``z`` and the conv carry."""
    b, s, _ = x.shape
    h, n, pdim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    z, xs, bc, cc, dt, a = _mamba_project(x, p, cfg)
    xs, conv_state = _causal_conv(xs, p["conv_w"].to(COMPUTE_DTYPE))
    xh = xs.reshape(b, s, h, pdim)
    beff = (bc[:, :, None, :] * dt[..., None]).to(COMPUTE_DTYPE)  # (B,S,H,N)
    ceff = cc[:, :, None, :].expand(b, s, h, n)
    return (xh, a, beff, ceff), z, conv_state


def _scan(x, a, b, c, *, train: bool, analysis: bool, ctx):
    """The recurrence: the stub under ``analysis``; for training the plain
    chunked scan, which autograd differentiates (the kernel has no
    backward); else ``kops.ssm_scan`` (the kernel on the card). On a mesh,
    on each rank's batch shard (every input and output is batch-first)."""
    if analysis:
        scan = functools.partial(kops.ssm_scan, analysis=True)
    else:
        scan = kref.ssm_scan_chunked if train else kops.ssm_scan
    if not on_mesh(ctx):
        return scan(x, a, b, c)
    ins = tuple(batch_spec(ctx, t.shape) for t in (x, a, b, c))
    b_, _, h, _ = x.shape
    outs = (ins[0], batch_spec(ctx, (b_, h, c.shape[-1], x.shape[-1])))
    return shard_map_compat(lambda *t: tuple(scan(*t)), mesh=ctx.mesh, in_specs=ins,
                            out_specs=outs)(x, a, b, c)


def mamba2_block(
    x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *, return_cache: bool = False,
    train: bool = False, analysis: bool = False, ctx=None,
):
    """x: (B, S, D) -> (B, S, D). Prefill and training path (chunked scan).
    ``return_cache`` also returns the final recurrence and conv state."""
    (xh, a, beff, ceff), z, conv_state = mamba2_scan_inputs(x, p, cfg)
    y, hfinal = _scan(xh, a, beff, ceff, train=train, analysis=analysis, ctx=ctx)
    out = _mamba_readout(y, xh, z, p, cfg)
    if return_cache:
        return out, {"state": hfinal, "conv": conv_state}
    return out


def mamba2_init_cache(
    cfg, batch: int, dtype=torch.float32, *, device=None
) -> Dict[str, torch.Tensor]:
    h, n, pdim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    d_in = cfg.ssm_expand * cfg.d_model
    return {
        "state": torch.zeros((batch, h, n, pdim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, d_in), dtype=dtype, device=device),
    }


def mamba2_decode(
    x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, cache: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D); O(1) state update. Returns a new cache; the given one
    is not modified."""
    b = x.shape[0]
    h, n, pdim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    z, xs, bc, cc, dt, a = _mamba_project(x, p, cfg)
    xs, conv_new = _causal_conv(xs, p["conv_w"].to(COMPUTE_DTYPE), cache["conv"])
    xh = xs.reshape(b, 1, h, pdim)
    beff = bc[:, 0, None, :] * dt[:, 0, :, None]  # (B,H,N)
    state = (
        a[:, 0, :, None, None] * cache["state"]
        + beff[..., None] * xh[:, 0, :, None, :].float()
    )
    y = torch.einsum("bhnp,bhn->bhp", state, cc[:, 0, None, :].expand(b, h, n).float())
    return _mamba_readout(y[:, None], xh, z, p, cfg), {"state": state, "conv": conv_new}


# ---------------------------------------------------------------------------
# Mamba2 as Zyphra publishes it (Zamba2-7B)
# ---------------------------------------------------------------------------


def _group_norm_gated(y, z, p, cfg):
    """``RMSNormGated``: y·SiLU(z) normalised over each group's d_inner / G
    channels in fp32, scaled by 1 + ``norm``, in bf16. y: (..., d_inner)."""
    y = y.float() * F.silu(z.float())
    shape, g = y.shape, cfg.ssm_ngroups
    y = F.rms_norm(y.reshape(*shape[:-1], g, shape[-1] // g), (shape[-1] // g,), None, cfg.norm_eps)
    return (y.reshape(shape) * (1.0 + p["norm"])).to(COMPUTE_DTYPE)


def _decay(dt, p):
    """dt = softplus(dt + dt_bias) and the decay exp(−dt·exp(A_log)), fp32."""
    dt = F.softplus(dt.float() + p["dt_bias"])
    return dt, torch.exp(dt * -torch.exp(p["a_log"]))


def _per_head(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N): each head takes its group's row, head
    h group h // (H / G). A copy: the scan kernel reads (B, S, H, N)."""
    return t.repeat_interleave(heads // t.shape[2], dim=2)


def mamba2_grouped_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *,
                         return_cache: bool = False):
    """Zyphra's Mamba2 mixer, prefill. x: (B, S, D) -> (B, S, D):
    in-projection to z, xBC and dt; the depthwise conv (bias, then SiLU)
    over xBC; the scan (the kernel on the card), which takes B times dt
    and C copied to every head of their group; the D·x skip, the gated
    norm of each group, out-projection. ``return_cache`` also returns the
    final state and the conv carry."""
    b, s, _ = x.shape
    d_in, g, n, h = cfg.ssm_expand * cfg.d_model, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    z, xbc, dt = torch.split(matmul(x, p["in_proj"]), [d_in, cfg.ssm_conv_dim, h], dim=-1)
    xbc, conv = _causal_conv(xbc, p["conv_w"].to(COMPUTE_DTYPE), bias=p["conv_b"])
    xs, bg, cg = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt, a = _decay(dt, p)
    xh = xs.reshape(b, s, h, cfg.ssm_head_dim)
    beff = (_per_head(bg.reshape(b, s, g, n), h) * dt[..., None]).to(COMPUTE_DTYPE)
    y, hfinal = _scan(xh, a, beff, _per_head(cg.reshape(b, s, g, n), h), train=False,
                      analysis=False, ctx=None)
    y = y.float() + p["d_skip"][:, None] * xh.float()
    out = matmul(_group_norm_gated(y.reshape(b, s, d_in), z, p, cfg), p["out_proj"])
    if return_cache:
        return out, {"state": hfinal, "conv": conv}
    return out


def mamba2_grouped_init_cache(cfg, batch: int, dtype=torch.float32, *,
                              device=None) -> Dict[str, torch.Tensor]:
    h, n, pdim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    return {
        "state": torch.zeros((batch, h, n, pdim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_K - 1, cfg.ssm_conv_dim), dtype=dtype, device=device),
    }


def mamba2_grouped_decode(
    x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, cache: Dict[str, torch.Tensor],
    out: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """x: (B, 1, D) -> (B, 1, D); O(1) state update, in fp32 after the
    in-projection (the conv's taps summed in fp32 too), each head reading
    its group's B and C without a copy, in few launches: decoding is bound
    by them. The new state and conv carry are written into ``out``'s
    tensors (shaped as ``cache``'s); ``cache`` is not modified."""
    b = x.shape[0]
    d_in, g, n, h, pd = (cfg.ssm_expand * cfg.d_model, cfg.ssm_ngroups, cfg.ssm_state,
                         cfg.ssm_heads, cfg.ssm_head_dim)
    z, xbc, dt = torch.split(matmul(x[:, 0], p["in_proj"]), [d_in, cfg.ssm_conv_dim, h], dim=-1)
    taps = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (B, K, C)
    out["conv"].copy_(taps[:, 1:])
    xbc = F.silu(torch.einsum("bkc,kc->bc", taps.float(), p["conv_w"].float()) + p["conv_b"])
    xs, bg, cg = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt, a = _decay(dt, p)
    xh = xs.reshape(b, g, h // g, pd)
    dx = dt.reshape(b, g, h // g, 1) * xh  # (B, G, H/G, P)
    state = cache["state"].reshape(b, g, h // g, n, pd) * a.reshape(b, g, h // g, 1, 1)
    state = torch.add(state, bg.reshape(b, g, 1, n, 1) * dx[:, :, :, None, :],
                      out=out["state"].view(b, g, h // g, n, pd))
    y = torch.einsum("bghnp,bgn->bghp", state, cg.reshape(b, g, n))
    y = (y + p["d_skip"].reshape(g, h // g, 1) * xh).reshape(b, 1, d_in)
    return matmul(_group_norm_gated(y, z[:, None], p, cfg), p["out_proj"])


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} stream; ``prev`` is the carry-in last token (B, D)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _rwkv_mix(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _rwkv_project(x, xprev, p, cfg):
    b, s, d = x.shape
    h, n = cfg.ssm_heads, cfg.ssm_head_dim
    r = matmul(_rwkv_mix(x, xprev, p["mu_r"]), p["w_r"])
    k = matmul(_rwkv_mix(x, xprev, p["mu_k"]), p["w_k"])
    v = matmul(_rwkv_mix(x, xprev, p["mu_v"]), p["w_v"])
    g = matmul(_rwkv_mix(x, xprev, p["mu_g"]), p["w_g"])
    # data-dependent per-channel decay (low-rank): w in (0, 1)
    xw = _rwkv_mix(x, xprev, p["mu_w"])
    wlog = p["w0"].float() + (
        torch.tanh(matmul(xw, p["w_lora_a"])).float() @ p["w_lora_b"].float()
    )
    w = torch.exp(-torch.exp(wlog))  # (B,S,D) per-channel decay
    shape = (b, s, h, n)
    return r.reshape(shape), k.reshape(shape), v.reshape(shape), g, w.reshape(shape)


def _rwkv_readout(r, k, v, y_scan, p, cfg, b, s):
    """bonus + group-norm + gate input + out-proj input, shared by prefill
    and decode."""
    h, n = cfg.ssm_heads, cfg.ssm_head_dim
    u = p["u"].float().reshape(h, n)
    rk = (r.float() * ((u - 1.0)[None, None] * k.float())).sum(-1, keepdim=True)
    y = y_scan.float() + rk * v.float()
    # per-head group norm; the variance is the population one, as jnp.var's
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y * p["ln_w"].float().reshape(1, 1, h, n) + p["ln_b"].float().reshape(1, 1, h, n)
    return y.reshape(b, s, h * n).to(COMPUTE_DTYPE)


def rwkv6_block(
    x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *, return_state: bool = False,
    analysis: bool = False, train: bool = False, ctx=None,
):
    """RWKV-6 time-mix, prefill and training path. x: (B, S, D)."""
    b, s, d = x.shape
    xprev = _token_shift(x)
    r, k, v, g, w = _rwkv_project(x, xprev, p, cfg)
    # recurrence: h_t = diag(w_t) h_{t-1} + k_t ⊗ v_t ; y = r·h_t (per-channel decay)
    y_scan, hfinal = _scan(v, w, k, r, train=train, analysis=analysis, ctx=ctx)
    y = _rwkv_readout(r, k, v, y_scan, p, cfg, b, s)
    y = y * F.silu(g.float()).to(COMPUTE_DTYPE)
    out = matmul(y, p["w_o"])
    if return_state:
        return out, hfinal
    return out


def rwkv6_init_cache(
    cfg, batch: int, dtype=torch.float32, *, device=None
) -> Dict[str, torch.Tensor]:
    h, n = cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "state": torch.zeros((batch, h, n, n), dtype=torch.float32, device=device),
        "tm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv6_decode(
    x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, cache: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D); O(1) per-token state update. Returns a new cache; the
    given one is not modified (prefill caches are shared across runs)."""
    b = x.shape[0]
    xprev = cache["tm_prev"][:, None, :].to(x.dtype)
    r, k, v, g, w = _rwkv_project(x, xprev, p, cfg)
    state = (
        w[:, 0, :, :, None].float() * cache["state"]
        + k[:, 0, :, :, None].float() * v[:, 0, :, None, :].float()
    )
    y_scan = torch.einsum("bhnp,bhn->bhp", state, r[:, 0].float())[:, None]
    y = _rwkv_readout(r, k, v, y_scan, p, cfg, b, 1)
    y = y * F.silu(g.float()).to(COMPUTE_DTYPE)
    out = matmul(y, p["w_o"])
    return out, {"state": state, "tm_prev": x[:, 0], "cm_prev": cache["cm_prev"]}


def rwkv6_channel_mix(
    x: torch.Tensor, p: Dict[str, torch.Tensor], prev: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV FFN (channel mix). Returns (y, last_token)."""
    dt = COMPUTE_DTYPE
    xprev = _token_shift(x, prev)
    xk = _rwkv_mix(x, xprev, p["mu_ck"])
    xr = _rwkv_mix(x, xprev, p["mu_cr"])
    kk = torch.square(torch.relu(matmul(xk, p["w_ck"]).float()))
    y = matmul(kk.to(dt), p["w_cv"])
    rr = torch.sigmoid(matmul(xr, p["w_cr"]).float()).to(dt)
    return rr * y, x[:, -1]
