"""Plain PyTorch versions of the kernels' functions: the neighbourhood shift,
dilation, erosion and grayscale reconstruction by dilation (for
:mod:`repro_torch.kernels.morph_recon` and the application layer), the
diagonal-gated linear recurrence (for :mod:`repro_torch.kernels.ssm_scan`)
and causal attention (for :mod:`repro_torch.kernels.flash_attention`).
They are the correctness references for the CUDA kernels. Every function
here runs on any device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "neighbors",
    "shift2d",
    "dilate",
    "erode",
    "morph_reconstruct_ref",
    "ssm_scan_ref",
    "ssm_scan_chunked",
    "ssm_scan_three_pass",
    "ssm_scan_stub",
    "attention_ref",
    "flash_attention_blocked",
    "uses_tensor_cores",
]


def neighbors(conn: int) -> Tuple[Tuple[int, int], ...]:
    if conn == 4:
        return ((1, 0), (-1, 0), (0, 1), (0, -1))
    if conn == 8:
        return ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))
    raise ValueError(f"connectivity must be 4 or 8, got {conn}")


def shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Shift a 2D tensor by (dy, dx), filling vacated cells with ``fill``:
    ``out[i, j] = x[i - dy, j - dx]``. Pads on the side the shift vacates,
    then slices the window back out."""
    h, w = x.shape
    padded = F.pad(x, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)), value=fill)
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return padded[y0 : y0 + h, x0 : x0 + w]


def dilate(x: torch.Tensor, conn: int = 8) -> torch.Tensor:
    out = x
    for dy, dx in neighbors(conn):
        out = torch.maximum(out, shift2d(x, dy, dx, float("-inf")))
    return out


def erode(x: torch.Tensor, conn: int = 8) -> torch.Tensor:
    out = x
    for dy, dx in neighbors(conn):
        out = torch.minimum(out, shift2d(x, dy, dx, float("inf")))
    return out


def morph_reconstruct_ref(
    marker: torch.Tensor, mask: torch.Tensor, conn: int = 8
) -> torch.Tensor:
    """Grayscale reconstruction by dilation, iterated to the global fixpoint.

    Invariants: marker ≤ mask is enforced on entry; the result r satisfies
    marker ≤ r ≤ mask and r is the least fixpoint above the marker of
    ``r = min(dilate(r), mask)``. One host sync per step (the ``any``).
    """
    mask = mask.to(torch.float32)
    m = torch.minimum(marker.to(torch.float32), mask)
    while True:
        new = torch.minimum(dilate(m, conn=conn), mask)
        if not bool(torch.any(new != m)):
            return new
        m = new


# ---------------------------------------------------------------------------
# Diagonal-gated linear recurrence (for kernels/ssm_scan.py)
# ---------------------------------------------------------------------------


def _per_channel(a: torch.Tensor, n: int) -> torch.Tensor:
    """A (B, S, H) scalar-per-head decay broadcast over the state dim."""
    return a.unsqueeze(-1).expand(*a.shape, n) if a.dim() == 3 else a


def ssm_scan_ref(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one token at a time (the oracle):

        h_t = a_t ⊙ h_{t-1} + b_t ⊗ x_t          (state: (N, P) per head)
        y_t = h_tᵀ · c_t

    Shapes: x (B, S, H, P) values; a (B, S, H) scalar-per-head decay
    (Mamba2) or (B, S, H, N) per-channel decay (RWKV-6), in (0, 1]; b, c
    (B, S, H, N); h (B, H, N, P). Returns (y in x's dtype, h_final fp32).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    a = _per_channel(a, n).float()
    xf, bf, cf = x.float(), b.float(), c.float()
    state = (
        torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
        if h0 is None else h0.float()
    )
    ys = []
    for t in range(s):
        state = a[:, t, :, :, None] * state + bf[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhnp,bhn->bhp", state, cf[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros(bsz, 0, h, p)
    return y.to(x.dtype), state


def ssm_scan_chunked(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    h0: Optional[torch.Tensor] = None, *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same recurrence in chunks of ``chunk`` tokens, in log space: the
    arithmetic of the TPU kernel and of the JAX package's ``ssm_scan_xla``,
    which the dispatch runs on CPU tensors. Within a chunk, with
    ``L_t = Σ_{i≤t} log a_i``:

        y_t    = Σ_{i≤t} (c_t · (exp(L_t − L_i) ⊙ b_i)) x_i + (c_t ⊙ exp(L_t)) · h
        h_next = exp(L_C) ⊙ h + Σ_i (exp(L_C − L_i) ⊙ b_i) ⊗ x_i

    Every exponent is ≤ 0, so nothing overflows and nothing divides by a
    vanishing cumulative decay. A ragged last chunk is padded with a = 1,
    b = 0, which changes nothing.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    out_dtype = x.dtype
    a = _per_channel(a, n)
    cdim = min(chunk, s)
    spad = -(-s // cdim) * cdim
    pad = (0, 0, 0, 0, 0, spad - s)  # the S dim of (B, S, H, ·)
    x = F.pad(x.float(), pad)
    a = F.pad(a.float(), pad, value=1.0)
    b = F.pad(b.float(), pad)
    c = F.pad(c.float(), pad)
    hst = (
        torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
        if h0 is None else h0.float()
    )
    tri = torch.tril(torch.ones(cdim, cdim, dtype=torch.bool, device=x.device))
    ys = []
    for j in range(0, spad, cdim):
        xb, ab, bb, cb = (t[:, j : j + cdim] for t in (x, a, b, c))  # (B, C, H, ·)
        L = torch.cumsum(torch.log(torch.clamp_min(ab, 1e-37)), dim=1)
        diff = L[:, :, None] - L[:, None]  # (B, C, C, H, N), ≤ 0 on the lower triangle
        w = torch.where(tri[None, :, :, None, None], torch.exp(diff), 0.0)
        sti = torch.einsum("btihn,bthn,bihn->bhti", w, cb, bb)
        y = torch.einsum("bhti,bihp->bthp", sti, xb)
        y = y + torch.einsum("bthn,bhnp->bthp", cb * torch.exp(L), hst)
        dlast = torch.exp(L[:, -1:] - L)  # (B, C, H, N), ≤ 1
        hst = torch.exp(L[:, -1])[..., None] * hst + torch.einsum(
            "bthn,bthp->bhnp", bb * dlast, xb
        )
        ys.append(y)
    return torch.cat(ys, 1)[:, :s].to(out_dtype), hst


def ssm_scan_three_pass(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    h0: Optional[torch.Tensor] = None, *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same recurrence in the CUDA kernel's three passes, every chunk at
    once but for the carry, with L counted from each chunk's start:

    (a) per chunk: L, the intra-chunk weights ``s`` (for a (B, S, H) decay
        ``(c bᵀ) ⊙ exp(L_t − L_i)``, one exponential a token pair; for a
        per-channel one ``Σ_n c exp(L_t − L_i) b``), ``y = s x``, the local
        state ``(b ⊙ exp(L_last − L))ᵀ x`` and the decay ``exp(L_last)``;
    (b) in order over the chunks: ``h_k = exp(L_last,k) ⊙ h_{k−1} + local_k``;
    (c) per chunk: ``y += (c ⊙ exp(L)) h_{k−1}``; with a per-head decay,
        ``exp(L_t)`` scales the rows of ``c h_{k−1}``.

    Every exponent is ≤ 0. A ragged last chunk is padded with a = 1 and
    b = c = x = 0."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    per_head = a.dim() == 3
    cdim = min(chunk, s)
    nc = -(-s // cdim)
    pad = (0, 0, 0, 0, 0, nc * cdim - s)  # the S dim of (B, S, H, ·)

    def chunks(t, value=0.0):  # (B, S, H, ·) -> (B, nc, C, H, ·)
        t = F.pad(t.float(), pad if t.dim() == 4 else pad[2:], value=value)
        return t.reshape(bsz, nc, cdim, *t.shape[2:])

    xc, bc, cc = chunks(x), chunks(b), chunks(c)
    L = torch.cumsum(torch.log(torch.clamp_min(chunks(a, 1.0), 1e-37)), dim=2)
    Ln = L[..., None] if per_head else L  # (B, nc, C, H, 1 or N)
    tri = torch.tril(torch.ones(cdim, cdim, dtype=torch.bool, device=x.device))
    if per_head:
        diff = (L[:, :, :, None] - L[:, :, None]).permute(0, 1, 4, 2, 3)  # (B, nc, H, t, i)
        w = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        sti = torch.einsum("bkthn,bkihn->bkhti", cc, bc) * w
    else:
        diff = L[:, :, :, None] - L[:, :, None]  # (B, nc, t, i, H, N)
        w = torch.where(tri[:, :, None, None], torch.exp(torch.where(
            tri[:, :, None, None], diff, 0.0)), 0.0)
        sti = torch.einsum("bktihn,bkthn,bkihn->bkhti", w, cc, bc)
    y = torch.einsum("bkhti,bkihp->bkthp", sti, xc)
    local = torch.einsum("bkthn,bkthp->bkhnp", bc * torch.exp(Ln[:, :, -1:] - Ln), xc)
    decay = torch.exp(Ln[:, :, -1])  # (B, nc, H, 1 or N)
    hst = (
        torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
        if h0 is None else h0.float()
    )
    carry = []
    for k in range(nc):
        carry.append(hst)
        hst = decay[:, k, :, :, None] * hst + local[:, k]
    hin = torch.stack(carry, 1)  # (B, nc, H, N, P): h_{k−1}
    if per_head:  # exp(L_t) scales the rows of c·h
        y = y + torch.exp(Ln) * torch.einsum("bkthn,bkhnp->bkthp", cc, hin)
    else:
        y = y + torch.einsum("bkthn,bkhnp->bkthp", cc * torch.exp(Ln), hin)
    return y.reshape(bsz, nc * cdim, h, p)[:, :s].to(x.dtype), hst


def ssm_scan_stub(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analysis-mode stand-in: keeps the shapes and a data dependence on
    every input at O(S) cost; the recurrence's true cost is counted in
    closed form elsewhere."""
    amean = (a if a.dim() == 4 else a.unsqueeze(-1)).mean(-1, keepdim=True)
    y = x * amean * b.mean(-1, keepdim=True) * c.mean(-1, keepdim=True)
    hf = b[:, -1, :, :, None] * x[:, -1, :, None, :]
    return y.to(x.dtype), hf.float()


# ---------------------------------------------------------------------------
# Attention (for kernels/flash_attention.py)
# ---------------------------------------------------------------------------

_NEG = -1e30  # the masked logit of the TPU kernel


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense attention, the oracle. q (B, Sq, H, D); k, v (B, Sk, KV, D)
    with H a multiple of KV (query head h reads kv head h // (H/KV)).
    Queries sit at the end of the keys (``qpos = i + Sk - Sq``); ``window``
    keeps keys in [qpos - window + 1, qpos]. Masked logits are -inf and a
    row with no key left is 0. Returns q's dtype."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    if scale is None:  # 1 / sqrt(d) in q's dtype, as jnp.sqrt(d).astype(q.dtype)
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    logits = logits.masked_fill(~m, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # rows with every key masked
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def uses_tensor_cores(dtype: torch.dtype, d: int) -> bool:
    """Whether attention on these inputs takes the tensor-core kernel (and
    its arithmetic): bf16 with a head dim that is a multiple of 16 up to
    128. Everything else takes the CUDA-core kernel in IEEE fp32."""
    return dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= 128


def flash_attention_blocked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
    block_q: int = 128, block_k: int = 128,
) -> torch.Tensor:
    """The TPU kernel's arithmetic, block by block: fp32 logits of
    ``q·scale`` and k, masked to -1e30 (``kpos < Sk``; ``kpos <= qpos`` when
    causal; ``kpos > qpos - window`` with a window; ``qpos = i + q_offset``),
    a streaming softmax with fp32 running max, sum and accumulator, and
    ``acc / max(l, 1e-30)`` in q's dtype. A (q-block, k-block) pair that is
    wholly masked is skipped on the TPU kernel's test.

    A masked logit adds 0 to the sum: that is what ``exp(-1e30 - m)`` gives
    as soon as the row has one key, and it makes a row with no key 0, as
    in :func:`attention_ref`, whatever the block size.

    Where :func:`uses_tensor_cores` holds (bf16, D a multiple of 16 up to
    128) it repeats the tensor-core kernel's arithmetic instead, which is the
    JAX model's: the logits are q·k of the bf16 values in fp32, times the
    scale in fp32, and the probabilities are rounded to bf16 before the P·V
    product (the sum ``l`` keeps them in fp32). Each key block's
    probabilities are rounded against the running max of the blocks so far,
    so this result depends on ``block_k``; the default, 128, is the kernel's
    key tile. Otherwise the CUDA-core kernel's: ``q·scale`` in fp32 and the
    probabilities in fp32."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    bq, bk = min(block_q, sq), min(block_k, sk)
    scale = 1.0 / math.sqrt(d)
    tensor_cores = uses_tensor_cores(q.dtype, d)
    qf = q.float().transpose(1, 2)  # (B, H, Sq, D)
    if not tensor_cores:
        qf = qf * scale
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)  # (B, H, Sk, D)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    for q_lo in range(0, sq, bq):
        rows = torch.arange(q_lo, min(q_lo + bq, sq), device=q.device)
        qpos = (rows + q_offset)[:, None]
        qb = qf[:, :, rows]
        m = torch.full((b, h, len(rows), 1), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, len(rows), d), dtype=torch.float32, device=q.device)
        # the TPU kernel's test, with its padded block's last row
        a_lo, a_hi = q_lo + q_offset, q_lo + q_offset + bq - 1
        for k_lo in range(0, sk, bk):
            if causal and k_lo > a_hi:
                continue
            if window is not None and k_lo + bk <= a_lo - window + 1:
                continue
            kpos = torch.arange(k_lo, min(k_lo + bk, sk), device=q.device)[None, :]
            mask = torch.ones((len(rows), kpos.shape[1]), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            logits = qb @ kf[:, :, k_lo : k_lo + bk].transpose(-1, -2)
            if tensor_cores:
                logits = logits * scale
            logits = logits.masked_fill(~mask, _NEG)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new).masked_fill(~mask, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            pv = p.to(torch.bfloat16).float() if tensor_cores else p
            acc = acc * corr + pv @ vf[:, :, k_lo : k_lo + bk]
            m = m_new
        out[:, :, rows] = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(q.dtype)
