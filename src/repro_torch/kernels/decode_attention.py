"""Decode attention: the hand-written CUDA kernel for Hopper
(``csrc/decode_attention.cu``) behind
:func:`repro_torch.models.attention.decode_attention` on the card, its
build and its wrapper.

The kernel replaces no Pallas kernel: the JAX package computes decode
attention as plain einsums around a softmax. It was added because that
arithmetic, run as PyTorch operations on the card, upcast each bf16 cache to
fp32 and copied it again into the einsums' layout: about ten times the
cache's bytes a call. The kernel reads K and V once, in bf16, the dtype in
which every path allocates its cache; its source says how it is laid out and what bounds it. Its arithmetic is that
of the CPU route of ``decode_attention`` (the plain version), but for the
order of the sums. It is built by :mod:`repro_torch.kernels.nvcc` at first
use. There is no fallback: a missing ``nvcc``, a failed build or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Tuple, Union

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.nvcc import Build, DeviceTotal, DeviceTotals, LaunchCount

__all__ = ["build", "LAUNCHES", "CALLS", "MAX_REP", "MIN_ROWS", "decode_attention_cuda",
           "split_plan", "bound_bytes"]

MAX_REP = 8  # q heads a kv head: the kernel holds a group's q in registers
MAX_D = 256  # a cache row on at most one warp, 8 elements a lane
MIN_ROWS = 32  # the fewest cache rows a split (a block) streams


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build (once per source and flag set) and load the kernel's library."""
    built = nvcc.build_library("decode_attention")
    lib = built.lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention.argtypes = [
        ptr, ctypes.c_float, i32,  # q, q_scale, round_q
        ptr, ctypes.POINTER(i64), ptr, ctypes.POINTER(i64),  # k, its strides, v, its strides
        i32, i32, i32, i32, i32,  # b, s, heads, kv_heads, d
        ptr, i64, i64,  # cur_dev, cur_host, window
        i32, i32, ptr, ptr, ptr, ptr,  # nsplit, rows, out, scratch, calls, stream
    ]
    lib.decode_attention.restype = i32
    lib.decode_attention_blocks_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
    lib.decode_attention_blocks_per_sm.restype = i32
    lib.decode_attention_scratch.argtypes = [i32, i32, i32, i32, i64, i32]
    lib.decode_attention_scratch.restype = i64
    return built


@functools.lru_cache(maxsize=None)
def _slots(rep: int, device: int) -> int:
    """Blocks of either pass that the device holds at once: its SMs times
    the fewer of the two passes' blocks an SM; asked of the card once per
    group size and device."""
    blocks = ctypes.c_int()
    with torch.cuda.device(device):
        err = build().lib.decode_attention_blocks_per_sm(rep, ctypes.byref(blocks))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if err != 0:
        raise RuntimeError(f"decode_attention occupancy query failed: CUDA error {err}")
    return blocks.value * sms


def split_plan(pairs: int, lmax: int, slots: int) -> Tuple[int, int]:
    """(splits, rows a split) for a span of at most ``lmax`` cache rows on
    each of ``pairs`` (batch row, kv head) pairs, on a card that holds
    ``slots`` blocks at once: as many splits as fill the slots in one wave,
    each at least ``MIN_ROWS`` rows, and no split left empty."""
    splits = max(1, min(slots // pairs, -(-lmax // MIN_ROWS)))
    rows = -(-lmax // splits)
    return -(-lmax // rows), rows


def bound_bytes(batch: int, length: int, kv_heads: int, head_dim: int) -> int:
    """The bytes a call must read: bf16 K and V over ``length`` valid
    positions, once each."""
    return 2 * batch * length * kv_heads * head_dim * 2


# one per call of the wrapper (three CUDA launches)
LAUNCHES = LaunchCount()
# the calls the card ran, summed on the card: a CUDA graph's replays count
# too, where LAUNCHES counts the calls issued from Python
_TOTALS = DeviceTotals(1)
CALLS = DeviceTotal(_TOTALS, 0)


def decode_attention_cuda(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KV, D)
    v_cache: torch.Tensor,
    cur_len: Union[int, torch.Tensor],
    *,
    window: int,
    q_scale: float,
    round_q: bool,
) -> torch.Tensor:
    """One query token against the cache, masked to the ``cur_len`` valid
    positions within ``window``: logits ``(q * q_scale) . k`` in fp32, with
    ``q * q_scale`` rounded to bf16 where ``round_q``; the probabilities
    rounded to bf16 before P·V; the output bf16, shape (B, 1, H, D).

    Takes, on one CUDA device: a contiguous bf16 ``q``; bf16 caches whose
    last dim is contiguous and whose rows start on 16 bytes (no path holds
    another cache dtype, so none is taken); D a multiple of 8 up to 256; H a multiple of KV, at
    most 8 q heads a kv head. ``cur_len`` is an int in [1, S] or a 0-d
    int64 tensor on the same device, read by the kernel (a value outside
    [1, S] gives NaN). Launches three kernels on the current stream and
    does not wait for the card; scratch and output come from
    ``torch.empty``, so a CUDA graph can capture the call once the first
    call on the device has run outside a capture."""
    _check(q, k_cache, v_cache, cur_len, window)
    nvcc.check_forward_only("decode_attention", q, k_cache, v_cache)
    window = int(window)
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    lib = build().lib
    with torch.cuda.device(q.device):
        splits, rows = split_plan(b * kv, min(s, window), _slots(h // kv, q.device.index))
        scratch = torch.empty(lib.decode_attention_scratch(b, s, h, d, window, splits),
                              dtype=torch.float32, device=q.device)
        on_card = isinstance(cur_len, torch.Tensor)
        err = lib.decode_attention(
            q.data_ptr(), q_scale, int(round_q),
            k_cache.data_ptr(), (ctypes.c_longlong * 3)(*k_cache.stride()[:3]),
            v_cache.data_ptr(), (ctypes.c_longlong * 3)(*v_cache.stride()[:3]),
            b, s, h, kv, d,
            cur_len.data_ptr() if on_card else None, 0 if on_card else int(cur_len), window,
            splits, rows, out.data_ptr(), scratch.data_ptr(),
            _TOTALS.buffer(q.device).data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
        LAUNCHES.add()
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_len, window) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got shape {tuple(q.shape)}")
    b, _, h, d = q.shape
    for name, t in (("k_cache", k), ("v_cache", v)):
        if t.dim() != 4 or t.shape[0] != b or t.shape[3] != d:
            raise ValueError(f"{name} must be (B, S, KV, D) = ({b}, S, KV, {d}), "
                             f"got shape {tuple(t.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k_cache {tuple(k.shape)} and v_cache {tuple(v.shape)} must match")
    s, kv = k.shape[1], k.shape[2]
    if s == 0 or h % kv or h // kv > MAX_REP:
        raise ValueError(f"{h} q heads over {kv} kv heads and {s} positions: need S > 0, H a "
                         f"multiple of KV and at most {MAX_REP} q heads a kv head")
    if d % 8 or not 8 <= d <= MAX_D:
        raise ValueError(f"head dim {d} must be a multiple of 8 up to {MAX_D}")
    if max(b, kv) > 65535 or s >= 2**31:
        raise ValueError(f"shape {tuple(k.shape)} beyond the kernel's grid")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"q ({q.dtype}) and the caches ({k.dtype}, {v.dtype}) must be bf16")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k_cache", k), ("v_cache", v)):
        if t.stride(3) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the last dim must be contiguous and every row start on "
                             f"16 bytes (strides {t.stride()})")
    if not isinstance(window, numbers.Integral) or window < 1:
        raise ValueError(f"window must be an int >= 1, got {window!r}")
    if isinstance(cur_len, torch.Tensor):
        if cur_len.dim() != 0 or cur_len.dtype != torch.int64 or cur_len.device != q.device:
            raise ValueError(f"a tensor cur_len must be a 0-d int64 on {q.device}, got "
                             f"{tuple(cur_len.shape)} {cur_len.dtype} on {cur_len.device}")
    elif not isinstance(cur_len, numbers.Integral) or not 1 <= cur_len <= s:
        raise ValueError(f"cur_len must be an int in [1, {s}] or a device tensor, got {cur_len!r}")
    for name, t in (("q", q), ("k_cache", k), ("v_cache", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
