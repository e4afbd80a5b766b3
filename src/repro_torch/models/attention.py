"""Attention for prefill (causal, sliding-window, prefix-LM, streaming
softmax) and decode (one query against the whole cache).

The JAX package computes both in plain JAX: its model calls no Pallas
kernel (its ``blocked_attention`` is a scan over key chunks; the Pallas
FlashAttention kernel of ``repro.kernels`` computes the same causal and
windowed attention, and the port's hand-written kernels replace it).

Prefill follows the tensors' device. A CUDA tensor goes to the hand-written
attention kernels (:mod:`repro_torch.kernels.flash_attention`): the model's
bf16 q, k and v, at every head dim of the configs (64, 80, 128 and gemma3's
and PaliGemma's 256) and with PaliGemma's prefix-LM mask, take the
tensor-core one, which rounds the probabilities to bf16 before P·V as JAX
does, a key tile at a time; only fp32 inputs and head dims that are no
multiple of 16 would take the CUDA-core one. A CPU tensor runs the JAX
package's own streaming softmax over key chunks, with its bf16 operands and
fp32 sums, and so does training (``train=True``) on either device: the
kernels compute no gradient, and the JAX package's ``forward_train``
differentiates this arithmetic on every backend. Decode follows the
tensors' device too (:func:`decode_on_card`): a CUDA cache goes to the
hand-written decode kernel (:mod:`repro_torch.kernels.decode_attention`),
which reads the bf16 K and V once, with the JAX package's roundings (q
times the scale rounded to bf16 unless a scale is passed, the
probabilities rounded to bf16 before P·V), and a CPU cache to plain
PyTorch as the JAX package computes it.

On a mesh (``ctx``, :mod:`repro_torch.dist`) both run on each rank's shard
through ``local_map``: batch over the data-parallel axes and heads over
'model' where they divide (:func:`repro_torch.dist.sharding.qkv_spec`), so
the kernels see local tensors. Where the q heads are split over 'model' and
the kv heads are not, each rank takes the kv heads of its own q heads.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import mesh_axes, on_mesh, qkv_spec, shard_map_compat
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.layers import COMPUTE_DTYPE

__all__ = ["blocked_attention", "decode_attention", "decode_on_card"]

_NEG = -1e30


def _scale(q: torch.Tensor) -> float:
    """1/sqrt(D) rounded to q's dtype. JAX multiplies q by the Python float
    as a weakly typed scalar, which takes the array's dtype (bf16 for the
    model's q); PyTorch would multiply by the unrounded value. ``q *
    _scale(q)`` is then JAX's product: exact in fp32, rounded once."""
    return float(torch.tensor(1.0 / (q.shape[-1] ** 0.5), dtype=q.dtype))


def _scaled_q32(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """q times the logits' scale, in fp32: JAX's product rounded to bf16
    where ``scale`` is None, else ``scale`` applied in fp32."""
    if scale is None:
        return (q * _scale(q)).to(COMPUTE_DTYPE).float()
    return q.float() * float(scale)


def _on_shards(fn, ctx, q, k, v):
    """``fn(q, k, v)`` on each rank's shard of (B, S, heads, D) tensors:
    batch over dp and heads over 'model' where they divide; the output is
    laid out as q. Where q's heads are split and k's are not, each rank
    passes ``fn`` the kv heads of its q heads (whole groups cannot occur
    there: they would make 'model' divide the kv heads)."""
    qspec, kvspec = qkv_spec(ctx, q.shape), qkv_spec(ctx, k.shape)
    rep = q.shape[2] // k.shape[2]
    pick = None
    if qspec[2] is not None and kvspec[2] is None:
        hl = q.shape[2] // mesh_axes(ctx.mesh)[ctx.model_axis]
        lo = ctx.mesh.get_local_rank(ctx.model_axis) * hl
        if rep % hl == 0:  # part of one group: its kv head
            pick = slice(lo // rep, lo // rep + 1)
        else:  # groups cut across: each q head its own kv head
            pick = torch.arange(lo, lo + hl) // rep

    def local(ql, kl, vl):
        if pick is not None:
            kl, vl = kl[:, :, pick], vl[:, :, pick]
        return fn(ql, kl, vl)

    return shard_map_compat(local, mesh=ctx.mesh, in_specs=(qspec, kvspec, kvspec),
                            out_specs=qspec)(q, k, v)


def blocked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    window: int,  # full attention = Sk
    q_offset: int = 0,  # absolute position of q[0] (prefill continuation)
    prefix_len: int = 0,  # bidirectional prefix (PaliGemma prefix-LM)
    chunk: int = 1024,
    train: bool = False,  # the differentiable route, on either device
    ctx=None,  # ParallelCtx (repro_torch.dist) or None
    scale: Optional[float] = None,  # None: 1/sqrt(D) rounded to q's dtype, as JAX
) -> torch.Tensor:
    """Causal (+ sliding-window / prefix-LM) attention with an fp32
    streaming softmax. On the card, unless ``train``: the kernels. On the
    CPU, and for training: the JAX package's arithmetic over key chunks of
    ``chunk``, which autograd differentiates. On a mesh: the same on each
    rank's shard. A given ``scale`` multiplies the logits in fp32 (the
    kernels take it as it is; the plain route scales fp32 q), where the
    default scales q in its own dtype as the JAX package does."""
    if on_mesh(ctx):
        fn = functools.partial(blocked_attention, window=window, q_offset=q_offset,
                               prefix_len=prefix_len, chunk=chunk, train=train, scale=scale)
        return _on_shards(fn, ctx, q, k, v)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if not train and kops._on_card(q, None):
        # a window that reaches past every key masks nothing
        w = None if window >= sk + q_offset else int(window)
        if scale is not None:
            return flash_attention_cuda(q, k, v, causal=True, window=w, q_offset=q_offset,
                                        prefix_len=int(prefix_len), scale=float(scale))
        # q scaled in its dtype as JAX scales it, so the kernels take scale 1
        return flash_attention_cuda(q * _scale(q), k, v, causal=True, window=w,
                                    q_offset=q_offset, prefix_len=int(prefix_len), scale=1.0)
    rep = h // kv
    chunk = min(chunk, sk)
    pad = -(-sk // chunk) * chunk - sk
    k = F.pad(k, (0, 0, 0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = (torch.arange(sq, device=q.device) + q_offset)[:, None]  # (Sq, 1)
    # bf16 operands, fp32 products and sums (preferred_element_type=f32)
    q32 = _scaled_q32(q, scale).transpose(1, 2)  # (B, H, Sq, D)
    m = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk + pad, chunk):
        kb = k[:, c0 : c0 + chunk].repeat_interleave(rep, dim=2)
        vb = v[:, c0 : c0 + chunk].repeat_interleave(rep, dim=2)
        kb = kb.to(COMPUTE_DTYPE).float().transpose(1, 2)  # (B, H, chunk, D)
        vb = vb.to(COMPUTE_DTYPE).float().transpose(1, 2)
        logits = q32 @ kb.transpose(-1, -2)  # (B, H, Sq, chunk)
        kpos = torch.arange(c0, c0 + chunk, device=q.device)[None, :]
        mask = (kpos <= qpos) | (kpos < prefix_len)
        mask &= kpos > qpos - window
        mask &= kpos < sk  # key padding
        logits = logits.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(COMPUTE_DTYPE).float() @ vb
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, D)


def decode_on_card(cache: torch.Tensor) -> bool:
    """Whether :func:`decode_attention` against ``cache`` takes the decode
    kernel: exactly where the cache lies on a CUDA device. The calls that
    take it are counted on the card (``kernels.decode_attention.CALLS``)."""
    return kops._on_card(cache, None)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KV, D)
    v_cache: torch.Tensor,
    cur_len,  # number of valid cache positions: an int, or a 0-d long tensor
    *,
    window: int,  # full = S
    ctx=None,  # ParallelCtx (repro_torch.dist) or None
    scale: Optional[float] = None,  # as blocked_attention's
) -> torch.Tensor:
    """One-token attention against the full cache, masked to the valid
    positions within the window; on the card the decode kernel, on the CPU
    the JAX package's arithmetic; on a mesh, on each rank's shard."""
    if on_mesh(ctx):
        fn = functools.partial(decode_attention, cur_len=cur_len, window=window, scale=scale)
        return _on_shards(fn, ctx, q, k_cache, v_cache)
    if decode_on_card(k_cache):
        # the kernel scales q as _scaled_q32 does
        return decode_attention_cuda(
            q.contiguous(), k_cache, v_cache, cur_len, window=int(window),
            q_scale=_scale(q) if scale is None else float(scale), round_q=scale is None)
    return _decode_plain(q, k_cache, v_cache, cur_len, window=window, scale=scale)


def _decode_plain(q, k_cache, v_cache, cur_len, *, window, scale=None) -> torch.Tensor:
    """The JAX package's decode arithmetic in PyTorch: the CPU route of
    :func:`decode_attention`, and the decode kernel's plain version on
    either device."""
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    kpos = torch.arange(s, device=q.device)
    mask = (kpos < cur_len) & (kpos >= cur_len - window)
    # group q heads onto their kv head: h = kv * rep
    qg = _scaled_q32(q.reshape(b, 1, kv, rep, d), scale)
    lg = torch.einsum(
        "bqgrd,bkgd->bgrqk", qg, k_cache.to(COMPUTE_DTYPE).float()
    )  # (B, KV, rep, 1, S)
    lg = lg.masked_fill(~mask, _NEG)
    p = torch.softmax(lg, dim=-1).to(COMPUTE_DTYPE)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.float(), v_cache.to(COMPUTE_DTYPE).float())
    return out.to(COMPUTE_DTYPE).reshape(b, 1, h, d).to(q.dtype)
