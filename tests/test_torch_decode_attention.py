"""The decode attention route and its kernel (``kernels/decode_attention.py``,
``csrc/decode_attention.cu``).

On the CPU: the route takes the plain arithmetic for CPU tensors and hands
CUDA ones to the kernel with the scale as the plain route applies it; a
decode step makes the calls the model counts; the plain arithmetic equals the JAX
package's ``decode_attention``; the wrapper refuses what the kernel does not
take; the split plan covers the span.

On the card (``gpu``): the kernel against the plain arithmetic run on the
card, at Zamba2-7B's decode shape and at the other models' head dims and
group sizes, with windows, scales, a position on the card, strided caches
and inside a replayed CUDA graph.

Tolerance, and why: the kernel and the plain route make the same roundings
(q times the scale, the probabilities and the output to bf16) and differ
only in the order of their fp32 sums. So an output is within one bf16
rounding of the plain one: one bf16 step of the value, or of the output's
scale where the sums cancel.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs import zamba2_7b
from repro_torch.kernels import decode_attention as dk
from repro_torch.models import (attention as tattn, decode_attention_calls, decode_step,
                                init_cache, init_params)

BF16_ULP = 2 ** -7


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=BF16_ULP,
                               atol=BF16_ULP * float(want.abs().max()) / 2)


def _qkv(b, s, kv, rep, d, dtype=torch.bfloat16, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, 1, kv * rep, d)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, s, kv, d)).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)]


# -- the route on the CPU ---------------------------------------------------------


def test_cpu_route_takes_the_plain_arithmetic(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU cache reached the kernel")

    monkeypatch.setattr(tattn, "decode_attention_cuda", refuse)
    q, k, v = _qkv(2, 24, 2, 4, 32)
    launches = dk.LAUNCHES.value
    got = tattn.decode_attention(q, k, v, 17, window=9)
    assert not tattn.decode_on_card(k)
    assert torch.equal(got, tattn._decode_plain(q, k, v, 17, window=9))
    # a position held in a 0-d tensor masks as the int does
    assert torch.equal(tattn.decode_attention(q, k, v, torch.tensor(17), window=9), got)
    assert dk.LAUNCHES.value == launches


@pytest.mark.parametrize("scale", [None, 0.3])
def test_card_route_hands_the_kernel_the_plain_scale(monkeypatch, scale):
    """Where the predicate says the card, the kernel gets q times the plain
    route's scale: rounded in q's dtype and to bf16 where ``scale`` is None
    (the JAX product), applied in fp32 where it is given."""
    seen = {}

    def kernel(q, k, v, cur_len, *, window, q_scale, round_q):
        seen.update(cur_len=cur_len, window=window, q_scale=q_scale, round_q=round_q)
        return q

    monkeypatch.setattr(tattn, "decode_on_card", lambda cache: True)
    monkeypatch.setattr(tattn, "decode_attention_cuda", kernel)
    q, k, v = _qkv(1, 8, 1, 1, 48)
    tattn.decode_attention(q, k, v, 5, window=2**30, scale=scale)
    want = float(torch.tensor(48 ** -0.5, dtype=torch.bfloat16)) if scale is None else scale
    assert seen == dict(cur_len=5, window=2**30, q_scale=want, round_q=scale is None)


def _published_7b():
    path = pathlib.Path(__file__).resolve().parents[1] / "perfbench" / "configs" / "zamba2_7b.json"
    return zamba2_7b.from_hf(json.loads(path.read_text()))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS + tconfigs.PORT_ARCH_IDS)
def test_decode_attention_calls_counts_a_step(monkeypatch, arch):
    """The model's count is the calls a decode step makes: one step of each
    family's reduced model on the CPU, its calls counted."""
    from repro_torch.models import granite_hybrid as tgranite, model as tmodel, zamba2 as tzamba2

    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return tattn.decode_attention(*args, **kwargs)

    for mod in (tmodel, tzamba2, tgranite):
        monkeypatch.setattr(mod, "decode_attention", counted)
    params = init_params(cfg, 0, device="cpu")
    batch = ({"frame_embeds": torch.zeros(1, 1, cfg.d_model, dtype=torch.bfloat16)}
             if cfg.family == "audio" else {"tokens": torch.ones(1, 1, dtype=torch.long)})
    decode_step(cfg, params, batch, init_cache(cfg, 1, 8, device="cpu"), 3)
    assert len(calls) == decode_attention_calls(cfg)


@pytest.mark.parametrize("d,rep,window", [(64, 1, 2**30), (64, 8, 6), (80, 4, 2**30),
                                          (80, 1, 11), (224, 1, 2**30), (224, 4, 6),
                                          (256, 8, 2**30), (256, 4, 11)])
def test_plain_arithmetic_equals_jax(d, rep, window):
    import jax.numpy as jnp

    from repro.models import attention as jattn

    q, k, v = _qkv(2, 24, 2, rep, d, seed=d + rep)
    want = jattn.decode_attention(*[jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                                    for t in (q, k, v)], 17, window=window)
    got = tattn.decode_attention(q, k, v, 17, window=window)
    assert got.dtype == torch.bfloat16
    _close(got, torch.from_numpy(np.array(want.astype(jnp.float32))))


# -- the wrapper's checks, before any build ------------------------------------


def _refused(**change):
    q, k, v = _qkv(2, 16, 2, 2, 32)
    args = dict(q=q, k_cache=k, v_cache=v, cur_len=9, window=2**30)
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    (dict(q=torch.zeros(2, 2, 4, 32, dtype=torch.bfloat16)), ValueError),  # two tokens
    (dict(v_cache=torch.zeros(2, 15, 2, 32, dtype=torch.bfloat16)), ValueError),
    (dict(q=torch.zeros(2, 1, 3, 32, dtype=torch.bfloat16)), ValueError),  # H not a multiple
    (dict(q=torch.zeros(2, 1, 32, 32, dtype=torch.bfloat16)), ValueError),  # 16 a kv head
    (dict(q=torch.zeros(2, 1, 4, 12, dtype=torch.bfloat16),
          k_cache=torch.zeros(2, 16, 2, 12, dtype=torch.bfloat16),
          v_cache=torch.zeros(2, 16, 2, 12, dtype=torch.bfloat16)), ValueError),  # D 12
    (dict(k_cache=torch.zeros(2, 16, 2, 32, dtype=torch.float16),
          v_cache=torch.zeros(2, 16, 2, 32, dtype=torch.float16)), TypeError),
    (dict(v_cache=torch.zeros(2, 16, 2, 32)), TypeError),  # two cache dtypes
    (dict(k_cache=torch.zeros(2, 16, 2, 32), v_cache=torch.zeros(2, 16, 2, 32)), TypeError),
    (dict(q=torch.zeros(2, 1, 4, 32)), TypeError),  # an fp32 q
    (dict(q=torch.zeros(2, 1, 32, 4, dtype=torch.bfloat16).transpose(2, 3)), ValueError),
    (dict(k_cache=torch.zeros(2, 16, 32, 2, dtype=torch.bfloat16).transpose(2, 3)), ValueError),
    (dict(k_cache=torch.zeros(2, 16, 3, 36, dtype=torch.bfloat16)[:, :, :2, :32]), ValueError),
    (dict(window=0), ValueError),
    (dict(cur_len=0), ValueError),
    (dict(cur_len=17), ValueError),
    (dict(cur_len=torch.tensor(9, dtype=torch.int32)), ValueError),
    (dict(), ValueError),  # every check passes but the device: CPU tensors
])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    args = _refused(**change)
    launches = dk.LAUNCHES.value
    with pytest.raises(error):
        dk.decode_attention_cuda(args.pop("q"), args.pop("k_cache"), args.pop("v_cache"),
                                 args.pop("cur_len"), q_scale=1.0, round_q=True, **args)
    assert dk.LAUNCHES.value == launches


@pytest.mark.parametrize("pairs,lmax,slots", [(256, 3648, 132 * 4), (256, 3648, 132 * 6),
                                              (1, 512, 132 * 6), (16, 4096, 132 * 2),
                                              (2, 20, 1000), (2048, 100, 132)])
def test_split_plan_covers_the_span(pairs, lmax, slots):
    splits, rows = dk.split_plan(pairs, lmax, slots)
    assert splits * rows >= lmax > (splits - 1) * rows  # covered, no split empty
    assert splits == 1 or rows >= dk.MIN_ROWS
    assert splits == 1 or splits * pairs <= slots  # one wave of blocks


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _kernel_vs_plain(q, k, v, cur_len, *, window, scale=None):
    launches = dk.LAUNCHES.value
    got = tattn.decode_attention(q, k, v, cur_len, window=window, scale=scale)
    assert dk.LAUNCHES.value == launches + 1
    want = tattn._decode_plain(q, k, v, cur_len, window=window, scale=scale)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("cur_len", [3585, 3648])
def test_card_zamba2_7b_decode_shape(card, cur_len):
    cfg = _published_7b()
    q, k, v = _qkv(8, 3648, cfg.num_heads, 1, cfg.head_dim, device=card)
    calls = dk.CALLS.value
    _kernel_vs_plain(q, k, v, cur_len, window=2**30, scale=cfg.attn_scale)
    assert dk.CALLS.value == calls + 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_card_head_dims_and_groups(card, d, rep):
    q, k, v = _qkv(2, 300, 2, rep, d, seed=d * rep, device=card)
    for window in (2**30, 100, 7):
        for scale in (None, 0.11):
            _kernel_vs_plain(q, k, v, 257, window=window, scale=scale)
    _kernel_vs_plain(q, k, v, 1, window=2**30)  # one valid position
    _kernel_vs_plain(q, k, v, 300, window=300)  # the whole cache


@pytest.mark.gpu
def test_card_one_kv_head_windowed(card):
    """gemma3's shape: four q heads on one kv head, D 256, window 512."""
    q, k, v = _qkv(1, 4096, 1, 4, 256, device=card)
    _kernel_vs_plain(q, k, v, 4096, window=512)
    _kernel_vs_plain(q, k, v, 1000, window=512)


@pytest.mark.gpu
def test_card_position_on_the_card_equals_the_host_int(card):
    q, k, v = _qkv(2, 300, 4, 2, 80, device=card)
    for n in (1, 150, 300):
        host = _kernel_vs_plain(q, k, v, n, window=120)
        dev = tattn.decode_attention(q, k, v, torch.tensor(n, device=card), window=120)
        assert torch.equal(dev, host)
    # a position the host cannot check gives NaN, not an answer
    bad = tattn.decode_attention(q, k, v, torch.tensor(0, device=card), window=120)
    assert torch.isnan(bad.float()).all()


@pytest.mark.gpu
def test_card_strided_cache_equals_its_copy(card):
    """A mesh rank's kv heads of a larger cache (a strided view) read as
    their contiguous copy does, bit for bit."""
    q, k, v = _qkv(2, 200, 4, 2, 128, device=card)
    ks, vs = k[:, :, 1:3], v[:, :, 1:3]
    assert not ks.is_contiguous()
    got = _kernel_vs_plain(q, ks, vs, 177, window=2**30)
    assert torch.equal(got, tattn.decode_attention(q, ks.contiguous(), vs.contiguous(), 177,
                                                   window=2**30))
    assert torch.equal(got, tattn.decode_attention(q, ks, vs, 177, window=2**30))  # repeats


@pytest.mark.gpu
def test_card_graph_replays_at_two_positions(card):
    q, k, v = _qkv(2, 256, 2, 4, 224, device=card)
    pos = torch.zeros((), dtype=torch.long, device=card)
    tattn.decode_attention(q, k, v, pos + 1, window=2**30)  # the first call outside the capture
    torch.cuda.synchronize()
    launches = dk.LAUNCHES.value
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tattn.decode_attention(q, k, v, pos + 1, window=2**30, scale=0.1)
    assert dk.LAUNCHES.value == launches + 1
    for n in (100, 256):
        pos.fill_(n - 1)
        calls = dk.CALLS.value
        graph.replay()
        torch.cuda.synchronize()
        assert dk.CALLS.value == calls + 1
        assert torch.equal(out, tattn.decode_attention(q, k, v, n, window=2**30, scale=0.1))
        _close(out, tattn._decode_plain(q, k, v, n, window=2**30, scale=0.1))
