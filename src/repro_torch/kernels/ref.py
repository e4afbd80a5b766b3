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
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = [
    "neighbors",
    "shift2d",
    "dilate",
    "erode",
    "morph_reconstruct_ref",
    "clamp_scan",
    "TiledRecon",
    "morph_reconstruct_tiled",
    "ssm_scan_ref",
    "ssm_scan_chunked",
    "ssm_scan_three_pass",
    "ssm_scan_stub",
    "attention_ref",
    "flash_attention_blocked",
    "uses_tensor_cores",
    "wgmma_key_tile",
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


def clamp_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan, along the last dim, of the clamp functions
    ``f_x(u) = min(max(u, a[x]), b[x])``, earliest first: returns (A, B)
    with ``f_x ∘ … ∘ f_0 = (u ↦ min(max(u, A[x]), B[x]))``.

    Clamps are closed under composition: ``(a1, b1)`` then ``(a2, b2)`` is
    ``(max(a1, a2), min(max(b1, a2), b2))``, so the scan is exact (only max
    and min touch the values). It takes the CUDA kernel's steps: offsets
    1, 2, 4, … with the identity ``(-inf, +inf)`` shifted in (the kernel's
    lanes without a source compose their pair with itself, which is the
    same: a clamp composed with itself is itself). ``v[x] = min(max(v[x-1], a[x]), b[x])``
    from a carry ``c`` is then ``min(max(c, A[x]), B[x])``."""
    n = a.shape[-1]
    d = 1
    while d < n:
        pad = [0] * (2 * (a.dim() - 1))
        a1 = F.pad(a[..., :-d], [d, 0] + pad, value=float("-inf"))
        b1 = F.pad(b[..., :-d], [d, 0] + pad, value=float("inf"))
        a, b = torch.maximum(a1, a), torch.minimum(torch.maximum(b1, a), b)
        d *= 2
    return a, b


def _raster_pass(
    v: torch.Tensor, mk: torch.Tensor, conn: int, dirty: torch.Tensor
) -> torch.Tensor:
    """One raster pass over a batch of tiles, in place: ``v`` (n, H+2, W+2)
    with a one-pixel halo that stays fixed, ``mk`` (n, H, W). Row by row
    from the top, each pixel takes the max over itself and the new row above
    (conn 8: three pixels, conn 4: one), then the row takes
    ``v[x] = min(max(v[x], v[x-1]), mask[x])`` from its left halo pixel by
    :func:`clamp_scan`.

    ``dirty`` (n, H) bool: the rows that changed since the tile was last
    left stable by a raster pass (all of them if it never was). A row that
    is not dirty and whose row above neither is dirty nor changed in this
    pass has the inputs it had then, so it is left as it is (a raster pass
    is idempotent). Returns the rows this pass changed, (n, H) bool."""
    changed = torch.zeros_like(dirty)
    for y in range(1, v.shape[1] - 1):
        run = dirty[:, y - 1]
        if y > 1:
            run = run | dirty[:, y - 2] | changed[:, y - 2]
        above = v[:, y - 1]
        up = above[:, 1:-1]
        if conn == 8:
            up = torch.maximum(torch.maximum(above[:, :-2], up), above[:, 2:])
        old = v[:, y, 1:-1]
        acc, lim = clamp_scan(torch.maximum(old, up), mk[:, y - 1])
        new = torch.minimum(torch.maximum(v[:, y, :1], acc), lim)
        new = torch.where(run[:, None], new, old)
        changed[:, y - 1] = (new != old).any(-1)
        v[:, y, 1:-1] = new
    return changed


# passes a visit of the CUDA kernel may run before its tile waits for the
# next round (``kernels/morph_recon.py`` passes it to the kernel)
MAX_PASSES = 4


def _lifts(q: torch.Tensor, moved: torch.Tensor, p: torch.Tensor, pmask: torch.Tensor,
           conn: int) -> torch.Tensor:
    """Along a tile's border (last dim): which moved border pixels ``q`` can
    raise a pixel of the neighbour's border next to them (the same position,
    and with conn 8 one to each side): ``min(q, pmask) > p``."""
    out = torch.minimum(q, pmask) > p
    if conn == 8:
        out[..., 1:] |= torch.minimum(q[..., 1:], pmask[..., :-1]) > p[..., :-1]
        out[..., :-1] |= torch.minimum(q[..., :-1], pmask[..., 1:]) > p[..., 1:]
    return out & moved


class TiledRecon(NamedTuple):
    result: torch.Tensor
    rounds: int
    tile_visits: int


def morph_reconstruct_tiled(
    marker: torch.Tensor, mask: torch.Tensor, conn: int = 8,
    tile: Union[int, Tuple[int, int]] = 32, *, max_passes: int = MAX_PASSES,
) -> TiledRecon:
    """Reconstruction by dilation in the CUDA kernel's schedule: the image
    cut into ``tile`` (rows, columns) tiles, rounds over a worklist of
    tiles, raster and anti-raster passes inside a tile. Returns the result
    (equal to :func:`morph_reconstruct_ref`) and the rounds and tile visits
    it took.

    Round 1 visits every tile of ``min(marker, mask)``. A visit reads the
    tile and its one-pixel halo (outside the image: -inf), then alternates
    raster and anti-raster passes (:func:`_raster_pass`; the anti-raster one
    on the tile turned by 180°) until a pass after the first changes
    nothing, or ``max_passes`` have run. A pass runs only the rows whose
    inputs changed since that direction last left the tile stable, and the
    rows after them that change (:func:`_raster_pass`).

    Tile t is visited in round k+1 when its own visit in round k hit the cap
    with its last pass still changing (then every row is dirty), or when a
    neighbour's visit in round k changed a pixel q of t's halo that can
    raise a pixel p of t next to it: ``min(q, mask[p]) > p``, with p as the
    neighbour read it at its visit's start (a value never above p's
    current one, so the test can only wake too often). The neighbour says
    which: a row of t's left or right halo column, t's halo row above or
    below, or (conn 8) a corner. The rows that read those pixels start
    dirty: a raster pass reads the left column (each row's carry), the row
    above (row 0) and, with conn 8, the side columns one row up; an
    anti-raster pass the mirror image. The call ends on an empty worklist. Every visit of a round reads the state at
    the round's start and writes at its end; the kernel's visits read and
    write as they go, so its rounds and visits may differ, never its
    result. ``max_passes`` must be at least 2.
    """
    if conn not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {conn}")
    if max_passes < 2:
        raise ValueError(f"max_passes must be at least 2, got {max_passes}")
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    mask = mask.to(torch.float32)
    h, w = mask.shape
    if h == 0 or w == 0:
        return TiledRecon(mask.clone(), 0, 0)
    ny, nx = -(-h // th), -(-w // tw)
    inf = float("inf")
    # the image padded to whole tiles and a one-pixel ring, all -inf
    m = F.pad(torch.minimum(marker.to(torch.float32), mask),
              (1, nx * tw - w + 1, 1, ny * th - h + 1), value=-inf)
    mkp = F.pad(mask, (1, nx * tw - w + 1, 1, ny * th - h + 1), value=-inf)
    dev = mask.device
    ry = torch.arange(th + 2, device=dev)
    rx = torch.arange(tw + 2, device=dev)

    def flags():  # what changed in each tile's halo, on a ring of padding tiles
        side = torch.zeros(ny + 2, nx + 2, th, dtype=torch.bool, device=dev)
        edge = torch.zeros(ny + 2, nx + 2, dtype=torch.bool, device=dev)
        return {"left": side, "right": side.clone(), "above": edge, "below": edge.clone(),
                "corner_above": edge.clone(), "corner_below": edge.clone(), "all": edge.clone()}

    woken = flags()
    woken["all"][1:-1, 1:-1] = True  # round 1: every tile, every row
    queue = torch.arange(ny * nx, device=dev)
    rounds = visits = 0
    while queue.numel():
        rounds += 1
        visits += queue.numel()
        ty, tx = queue // nx + 1, queue % nx + 1
        got = {name: f[ty, tx] for name, f in woken.items()}
        rows = ((queue // nx) * th)[:, None, None] + ry[None, :, None]
        cols = ((queue % nx) * tw)[:, None, None] + rx[None, None, :]
        v = m[rows, cols]  # (n, th+2, tw+2), the halo included
        start = v.clone()
        mk = mkp[rows[:, 1:-1], cols[:, :, 1:-1]]
        settled = torch.zeros(queue.numel(), dtype=torch.bool, device=dev)
        # rows whose inputs changed since the last raster / anti-raster pass
        dirty_fwd, dirty_bwd = got["left"].clone(), got["right"].clone()
        dirty_fwd[:, 0] |= got["above"] | got["corner_above"]
        dirty_bwd[:, -1] |= got["below"] | got["corner_below"]
        if conn == 8:
            sides = got["left"] | got["right"]
            dirty_fwd[:, 1:] |= sides[:, :-1]
            dirty_bwd[:, :-1] |= sides[:, 1:]
        dirty_fwd |= got["all"][:, None]
        dirty_bwd |= got["all"][:, None]
        for p in range(max_passes):
            if p % 2 == 0:
                rows_moved = _raster_pass(v, mk, conn, dirty_fwd)
                dirty_bwd = dirty_bwd | rows_moved if p == 0 else rows_moved
            else:  # anti-raster: the raster pass on the tile turned by 180°
                vr = v.flip(1, 2)
                rows_moved = _raster_pass(vr, mk.flip(1, 2), conn, dirty_bwd.flip(1)).flip(1)
                v = vr.flip(1, 2)
                dirty_fwd = rows_moved
            if p > 0:
                settled |= ~rows_moved.any(-1)
                if bool(settled.all()):
                    break
            # a settled tile's passes change nothing more: leave it as it is
        m[rows[:, 1:-1], cols[:, :, 1:-1]] = v[:, 1:-1, 1:-1]
        new = v[:, 1:-1, 1:-1]
        moved = new != start[:, 1:-1, 1:-1]
        mkh = mkp[rows, cols]  # the mask of the tile and its halo
        woken = flags()
        woken["all"][ty, tx] = ~settled
        # the tile above: its row below; the tile to the left: its right column
        woken["below"][ty - 1, tx] = _lifts(new[:, 0], moved[:, 0], start[:, 0, 1:-1],
                                            mkh[:, 0, 1:-1], conn).any(-1)
        woken["above"][ty + 1, tx] = _lifts(new[:, -1], moved[:, -1], start[:, -1, 1:-1],
                                            mkh[:, -1, 1:-1], conn).any(-1)
        woken["right"][ty, tx - 1] = _lifts(new[:, :, 0], moved[:, :, 0], start[:, 1:-1, 0],
                                            mkh[:, 1:-1, 0], conn)
        woken["left"][ty, tx + 1] = _lifts(new[:, :, -1], moved[:, :, -1], start[:, 1:-1, -1],
                                           mkh[:, 1:-1, -1], conn)
        if conn == 8:  # a corner pixel is in the halo of the diagonal neighbour
            for (a, b), (dy, dx) in (((0, 0), (-1, -1)), ((0, -1), (-1, 1)),
                                     ((-1, 0), (1, -1)), ((-1, -1), (1, 1))):
                lift = moved[:, a, b] & (torch.minimum(new[:, a, b], mkh[:, a, b]) > start[:, a, b])
                name = "corner_below" if dy < 0 else "corner_above"
                woken[name][ty + dy, tx + dx] |= lift
        live = torch.zeros(ny + 2, nx + 2, dtype=torch.bool, device=dev)
        for name, f in woken.items():
            live |= f.any(-1) if f.dim() == 3 else f
        queue = torch.nonzero(live[1:-1, 1:-1].reshape(-1)).reshape(-1)
    return TiledRecon(m[1 : h + 1, 1 : w + 1].clone(), rounds, visits)


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
    prefix_len: int = 0,
) -> torch.Tensor:
    """Dense attention, the oracle. q (B, Sq, H, D); k, v (B, Sk, KV, D)
    with H a multiple of KV (query head h reads kv head h // (H/KV)).
    Queries sit at the end of the keys (``qpos = i + Sk - Sq``); the causal
    mask keeps ``kpos <= qpos`` and, for a prefix-LM, every ``kpos <
    prefix_len``; ``window`` keeps keys in [qpos - window + 1, ...]. Masked
    logits are -inf and a row with no key left is 0. Returns q's dtype."""
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
        m &= (kpos <= qpos) | (kpos < prefix_len)
    if window is not None:
        m &= kpos > qpos - window
    logits = logits.masked_fill(~m, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # rows with every key masked
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def uses_tensor_cores(dtype: torch.dtype, d: int) -> bool:
    """Whether attention on these inputs takes the tensor-core kernel (and
    its arithmetic): bf16 with a head dim that is a multiple of 16 up to
    256, with or without a prefix. Everything else (fp32, other head dims)
    takes the CUDA-core kernel in IEEE fp32."""
    return dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= 256


def wgmma_key_tile(d: int) -> int:
    """The keys of one K/V tile of the tensor-core kernel at head dim ``d``:
    128 up to D = 128, 64 above, where a 128-key ring would not fit beside
    the q tile (csrc/flash_attention_wgmma.cu, ``key_tile``; the library's
    ``flash_attention_wgmma_key_tile`` gives the source's own number). Each
    tile's probabilities are rounded to bf16 against the running max of the
    tiles so far, so the plain version walks the same blocks."""
    return 128 if d <= 128 else 64


def flash_attention_blocked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
    prefix_len: int = 0, scale: Optional[float] = None, block_q: int = 128,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """The TPU kernel's arithmetic, block by block: fp32 logits of
    ``q·scale`` (1/sqrt(D) when ``scale`` is None) and k, masked to -1e30 (``kpos < Sk``; ``kpos <= qpos`` or
    ``kpos < prefix_len`` when causal; ``kpos > qpos - window`` with a
    window; ``qpos = i + q_offset``),
    a streaming softmax with fp32 running max, sum and accumulator, and
    ``acc / max(l, 1e-30)`` in q's dtype. A (q-block, k-block) pair that is
    wholly masked is skipped on the TPU kernel's test (a key block that
    starts inside the prefix is never skipped for being causal).

    A masked logit adds 0 to the sum: that is what ``exp(-1e30 - m)`` gives
    as soon as the row has one key, and it makes a row with no key 0, as
    in :func:`attention_ref`, whatever the block size.

    Where :func:`uses_tensor_cores` holds (bf16, D a multiple of 16 up to
    256) it repeats the tensor-core kernel's arithmetic instead, which is the
    JAX model's: the logits are q·k of the bf16 values in fp32, times the
    scale in fp32, and the probabilities are rounded to bf16 before the P·V
    product (the sum ``l`` keeps them in fp32). Each key block's
    probabilities are rounded against the running max of the blocks so far,
    so this result depends on ``block_k``; the default (None) is the
    kernel's key tile at this D, :func:`wgmma_key_tile`. Otherwise the
    CUDA-core kernel's: ``q·scale`` in fp32 and the probabilities in fp32."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    if block_k is None:
        block_k = wgmma_key_tile(d)
    bq, bk = min(block_q, sq), min(block_k, sk)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
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
            if causal and k_lo > a_hi and k_lo >= prefix_len:
                continue
            if window is not None and k_lo + bk <= a_lo - window + 1:
                continue
            kpos = torch.arange(k_lo, min(k_lo + bk, sk), device=q.device)[None, :]
            mask = torch.ones((len(rows), kpos.shape[1]), dtype=torch.bool, device=q.device)
            if causal:
                mask &= (kpos <= qpos) | (kpos < prefix_len)
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
