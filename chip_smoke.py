#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit, TF32 off; the three kernels
   start building (one ``nvcc`` each, in parallel);
2. build: the ``morph_recon`` CUDA kernel from the checkout's source;
3. kernel vs its plain PyTorch version on the card, ``torch.equal``, on
   random cases and on the real Seg2 and fill-holes inputs of the 4096²
   tile; each 4096² case also against the plain version of the kernel's
   schedule (``morph_reconstruct_tiled``) and three repeated kernel calls,
   with the kernel's time, launches, rounds, tile visits against tiles ×
   rounds, host round trips, bound and the plain time;
4. the single-tile SA study, ``repro_torch.app.run_study``, on a 4096²
   tile with the 16-run MOAT design over Table I, counting kernel launches,
   the kernel's rounds and tile visits, and its host round trips;
5. the same study code on card and CPU at 256², Dice within 1e-3;
6. build: the ``ssm_scan`` CUDA kernel (chunk-parallel: three passes);
7. ``ssm_scan`` vs its three plain versions on the card in fp32, on the
   cases of tests/test_kernel_ssm_scan.py, then at the prefill's real shape
   and types (layer 0 of RWKV-6 1.6B), with the kernel's time, bound and the
   plain times;
8. the SA-serve study, ``repro_torch.core.sa_serve.run_sa_serve``, on RWKV-6
   1.6B at full width: 3 prompts of 1024 tokens × 12 decoding settings ×
   3 thresholds, counting kernel launches;
9. the same serve study code on card and CPU on the reduced RWKV-6;
10. build: the two ``flash_attention`` CUDA kernels (CUDA cores; tensor
    cores with ``wgmma`` and TMA);
11. ``flash_attention`` vs its plain versions on the card: the cases of
    tests/test_kernel_flash_attention.py in fp32 on the CUDA-core kernel,
    and in bf16 on the tensor-core kernel; then at the prefill's real shape
    and types (the shared block's first application in Zamba2 2.7B), with
    both kernels' times, the bound, the plain time and the time of
    PyTorch's ``scaled_dot_product_attention`` on the same tensors;
12. the SA-serve study on Zamba2 2.7B at full width: 3 prompts of 4096
    tokens × 12 decoding settings × 3 thresholds, counting the kernels'
    launches (attention on the tensor-core kernel only);
13. the same serve study code on card and CPU on the reduced Zamba2;
14. ``morph_recon`` launched from two threads on two streams at once
    against its plain version, then the dataset study,
    ``repro_torch.app.run_dataset_study``, over 2 tiles of 4096² (tile 0 is
    phase 4's) with phase 4's MOAT runs and the default set, two thread
    workers, counting kernel launches and host round trips and timing each
    task;
15. the adaptive study, ``repro_torch.app.run_adaptive_study`` (MOAT →
    prune → VBD → refine, 3 rounds) on tile 0 over an ``obj:`` store,
    resumed from its saved state with zero recompute; then the same
    adaptive study code on card and CPU at 256², round records equal;
16. phase 14's dataset study through ``backend="process"``: two spawn
    workers, each with its own CUDA context, Dice equal to phase 14's, the
    workers' own report of their device and ``morph_recon`` launches, and
    what ``nvidia-smi`` shows on the card meanwhile;
17. phase 4's study through ``backend="socket"`` (two workers over
    loopback TCP), Dice equal to phase 4's, then again with one worker
    SIGKILLed while it holds a lease;
18. ``run_fleet_study`` (two spawned StudyDriver processes over one store
    directory, 2 rounds on one SIZE² tile) against one in-process
    StudyDriver over the same build: round records and best equal, no
    corrupt read;
19. the study service, ``repro_torch.service.StudyServer`` over
    ``pathology_service_build`` (one SIZE² tile, two thread workers): an
    explicit job equal to ``1 - Dice`` of ``run_study``, identical
    concurrent submissions executed once, a cancelled job, device memory
    returned, and ``python -m repro_torch.service serve`` answering two TCP
    tenants.

Phase 7 also holds ``ssm_scan`` at Mamba2's real shape (layer 0 of the
Zamba2 prefill: a per-head decay); phase 11 the CUDA-core attention kernel
at gemma3_1b's head dim 256, causal and with its 512-key window. The last three lines are the kernels
JSON, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import pathlib
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, same sheet
BF16_OPS_PER_S = 989.4e12  # H100 SXM bf16 tensor cores, dense, same sheet
SFU_OPS_PER_S = 132 * 16 * 1.98e9  # 16 MUFU ops a clock and SM (compute capability 9.0), boost clock
SIZE = 4096
SUB = 512  # the tile is an 8×8 mosaic of SUB² synthetic tiles
MOAT_RUNS = 16  # the whole 15-parameter trajectory: 16 runs
# phases 14 and 16; tile t's sub-tile seeds start at SEED_STEP * t. Cut from 4:
# on process workers each 4096² tile costs about two minutes of store spills
DATASET_TILES = 2
SEED_STEP = (SIZE // SUB) ** 2  # 64: no sub-tile seed repeats across tiles
ADAPTIVE_TILES = 1  # phase 15 at SIZE²: one tile (the label loops set its time)
ADAPTIVE = dict(max_rounds=3, n_trajectories=2, n_base=4, seed=0)
ARCH = "rwkv6_1p6b"
PROMPTS, PROMPT_LEN, GEN_LEN = 3, 1024, 16
ZAMBA, Z_PROMPT_LEN = "zamba2_2p7b", 4096
PENALTIES, TOP_KS = (1.0, 1.3), (4, 16)
# (B, S, H, N, P, chunk) and (S, chunk, per_channel, seed): the cases of
# tests/test_kernel_ssm_scan.py and tests/test_torch_ssm_scan.py
SCAN_SHAPES = [(1, 16, 1, 4, 4, 8), (2, 32, 2, 8, 16, 8), (1, 33, 1, 8, 8, 16),
               (1, 64, 3, 16, 32, 64)]
SCAN_SWEEP = [(4, 4, False, 0), (17, 8, True, 11), (33, 32, False, 5), (50, 16, True, 123),
              (64, 4, True, 7), (70, 32, True, 999), (9, 16, False, 42)]
# (b, s, h, kv, d), windows, and (s, h, window, seed): the cases of
# tests/test_kernel_flash_attention.py and tests/test_torch_flash_attention.py
FA_CAUSAL = [(1, 64, 2, 2, 32), (2, 128, 4, 2, 32), (1, 96, 4, 1, 16), (1, 80, 2, 2, 64)]
FA_WINDOWS = [8, 32, 100]
FA_PROPERTY = [(8, 1, None, 0), (17, 2, 4, 11), (33, 4, 64, 5), (50, 1, 16, 100),
               (64, 2, None, 7), (80, 4, 9, 99), (23, 2, 23, 42), (71, 1, 5, 3)]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke.py: check failed: {what}")


def recon_bound_ms(numel: int, conn: int) -> float:
    """Least time for one reconstruction on this card: marker and mask read
    once and the result written once (12 bytes a pixel) over the memory
    rate, or one max per neighbour and one min per pixel over the fp32
    rate, whichever is larger (always the bytes here)."""
    return max(12 * numel / HBM_BYTES_PER_S, (conn + 1) * numel / FP32_OPS_PER_S) * 1e3


def stored_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor reads: a dim broadcast with
    a zero stride (Mamba2's c over the heads) is read once."""
    return t.element_size() * math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)


def scan_bound(x, a, b, c, y, hf):
    """Least time for one scan on this card, and what bounds it: each input
    read once and each output written once over the memory rate, against
    the recurrence's 5·N·P flops a token and head (decay, input and
    readout products and sums) over the fp32 rate."""
    nbytes = sum(stored_bytes(t) for t in (x, a, b, c, y, hf))
    bsz, s, h, p = x.shape
    ops = 5 * bsz * s * h * b.shape[-1] * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def scan_case(b, s, h, n, p, per_channel, seed):
    """The inputs of tests/test_kernel_ssm_scan.py, on the card."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    a = np.exp(-np.exp(rng.normal(-1.0, 0.7, (b, s, h, n) if per_channel else (b, s, h))))
    bb = rng.normal(0, 0.5, (b, s, h, n)).astype(np.float32)
    c = rng.normal(0, 0.5, (b, s, h, n)).astype(np.float32)
    return [torch.from_numpy(v.astype(np.float32)).cuda() for v in (x, a, bb, c)]


def strong_decay_case():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (1, 48, 1, 8)).astype(np.float32)
    bb = rng.normal(0, 1, (1, 48, 1, 8)).astype(np.float32)
    c = rng.normal(0, 1, (1, 48, 1, 8)).astype(np.float32)
    a = np.full((1, 48, 1, 8), 1e-6, np.float32)
    return [torch.from_numpy(v).cuda() for v in (x, a, bb, c)]


def scan_real_shape(real, reps, plain_reps):
    """``ssm_scan`` at a prefill's real shape and types against the chunked
    plain version: y within one bf16 rounding of fp32 sums that agree to
    1e-4 of the largest y; h_final, fp32, to the kernel's bar relative to
    the largest state value; the same bars against the three-pass plain
    version, whose passes the kernel runs. Returns (kernel ms, chunked plain
    ms, three-pass plain ms, bound ms, what bounds it)."""
    from repro_torch.kernels import ref as kref, ssm_scan

    y, hf = ssm_scan.ssm_scan_cuda(*real)
    torch.cuda.synchronize()
    yp, hp = kref.ssm_scan_chunked(*real)
    ymax, hmax = float(yp.float().abs().max()), float(hp.abs().max())
    check(torch.allclose(y.float(), yp.float(), rtol=2 ** -7, atol=1e-4 * ymax),
          "real-shape y within one bf16 rounding of the plain version")
    check(torch.allclose(hf, hp, rtol=2e-4, atol=2e-4 * max(1.0, hmax)),
          "real-shape h_final within 2e-4 of the plain version")
    print(f"real shape: y max abs err {float((y.float() - yp.float()).abs().max())} "
          f"(max |y| {ymax}); h_final max abs err {float((hf - hp).abs().max())} "
          f"(max |h| {hmax})")
    y3, h3 = kref.ssm_scan_three_pass(*real)
    check(torch.allclose(y.float(), y3.float(), rtol=2 ** -7, atol=1e-4 * ymax),
          "real-shape y within one bf16 rounding of the three-pass plain version")
    check(torch.allclose(hf, h3, rtol=2e-4, atol=2e-4 * max(1.0, hmax)),
          "real-shape h_final within 2e-4 of the three-pass plain version")
    print(f"real shape vs three-pass: y max abs err {float((y.float() - y3.float()).abs().max())}; "
          f"h_final max abs err {float((hf - h3).abs().max())}")
    del yp, hp, y3, h3
    ms = cuda_ms(lambda: ssm_scan.ssm_scan_cuda(*real), reps)
    plain_ms = cuda_ms(lambda: kref.ssm_scan_chunked(*real), plain_reps)
    plain3_ms = cuda_ms(lambda: kref.ssm_scan_three_pass(*real), plain_reps)
    bound_ms, bound_by = scan_bound(*real, y, hf)
    print(f"real shape: kernel {ms:.4f} ms, plain (chunked) {plain_ms:.4f} ms, plain (three-pass) "
          f"{plain3_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); {ms / bound_ms:.1f}x bound")
    return ms, plain_ms, plain3_ms, bound_ms, bound_by


def attn_bound(q, k, v, out):
    """Least time for causal attention on this card, and what bounds it:
    q, k, v read and the output written once over the memory rate, against
    4·D flops a head for each (query, key) pair the mask keeps (the two
    products) over the bf16 tensor rate. Also the exponentials: one a kept
    pair and head."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    _, sq, h, d = q.shape
    pairs = q.shape[0] * sq * (sq + 1) // 2  # causal, Sq == Sk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * h * d * pairs / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, 4 * h * d * pairs, h * pairs)


def attn_pairs(sq: int, window=None) -> int:
    """(query, key) pairs a causal mask keeps over Sq == Sk, within
    ``window`` keys of the query when one is given."""
    if window is None or window >= sq:
        return sq * (sq + 1) // 2
    return window * (window + 1) // 2 + (sq - window) * window


def gemma3_attention(flash_attention, kref):
    """Phase 11 at head dim 256: gemma3_1b's attention shape, (1, 4096, 4,
    256) with one kv head, causal and with its local window 512, on the
    CUDA-core kernel (the tensor-core one stops at 128). fp32 against the
    oracle at 2e-5; bf16 within one bf16 rounding of the plain version's
    fp32 arithmetic. Times, bounds (fp32: the fp32 rate; bf16: the bf16
    tensor rate, against the bytes) and SDPA's time on the same tensors.
    Returns {case: numbers}."""
    from repro_torch import configs

    g = configs.get_config("gemma3_1b")
    shape = (1, Z_PROMPT_LEN, g.num_heads, g.num_kv_heads, g.head_dim)
    q, k, v = qkv_case(1, shape[1], shape[1], *shape[2:], seed=256)
    out = {}
    for window in (None, g.local_window):
        before, wgmma = flash_attention.LAUNCHES.value, flash_attention.WGMMA_LAUNCHES.value
        got = flash_attention.flash_attention_cuda(q, k, v, window=window)
        torch.cuda.synchronize()
        check(flash_attention.LAUNCHES.value == before + 1
              and flash_attention.WGMMA_LAUNCHES.value == wgmma,
              f"D = 256 window {window}: one CUDA-core launch")
        want = kref.attention_ref(q, k, v, window=window)
        check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
              f"D = 256 fp32 window {window} within 2e-5 of attention_ref")
        err = float((got - want).abs().max())
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        got_b = flash_attention.flash_attention_cuda(qb, kb, vb, window=window)
        torch.cuda.synchronize()
        check(flash_attention.WGMMA_LAUNCHES.value == wgmma, "D = 256 bf16 stays off the tensor cores")
        want_b = kref.flash_attention_blocked(qb, kb, vb, window=window)  # fp32 arithmetic here
        check(torch.allclose(got_b.float(), want_b.float(), rtol=2 ** -7, atol=2 ** -9),
              f"D = 256 bf16 window {window} within one bf16 rounding of flash_attention_blocked")
        err_b = float((got_b.float() - want_b.float()).abs().max())
        del want, want_b
        ms = cuda_ms(lambda: flash_attention.flash_attention_cuda(q, k, v, window=window), 5)
        ms_b = cuda_ms(lambda: flash_attention.flash_attention_cuda(qb, kb, vb, window=window), 5)
        pairs = attn_pairs(shape[1], window) * shape[2]  # a kept pair and query head
        flops = 4 * g.head_dim * pairs
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S) * 1e3
        bound_b = max(nbytes / 2 / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S) * 1e3
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                                     is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(shape[1], device=q.device)
            keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                                     attn_mask=keep, enable_gqa=True)
        sdpa_err = float((sdpa().transpose(1, 2) - got).abs().max())
        lib_ms = cuda_ms(sdpa, 5)
        name = "causal" if window is None else f"window {window}"
        print(f"gemma3_1b attention {shape[:3] + shape[4:]} kv {shape[3]} {name}: fp32 max abs err "
              f"{err:.3g} vs attention_ref, bf16 {err_b:.3g} vs blocked; kernel fp32 {ms:.4f} ms, "
              f"bf16 {ms_b:.4f} ms; bound fp32 {bound:.4f} ms, bf16 {bound_b:.4f} ms (operations: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB in fp32); library call "
              f"(scaled_dot_product_attention, fp32) {lib_ms:.4f} ms (max abs diff {sdpa_err:.3g}); "
              f"fp32 {ms / bound:.1f}x bound")
        out[name] = dict(ms=ms, bf16_ms=ms_b, bound_ms=bound, bf16_bound_ms=bound_b,
                         library_ms=lib_ms, max_abs_err=err, max_abs_err_bf16=err_b)
        del got, got_b, qb, kb, vb, qt, kt, vt, sdpa
    return out


def qkv_case(b, sq, sk, h, kv, d, seed):
    """The inputs of tests/test_kernel_flash_attention.py, on the card."""
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))
    return [torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)).cuda() for sh in shapes]


def serve_grid(n_prompts, thresholds):
    return [
        tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": k, "threshold": th}.items()))
        for p, rp, k, th in itertools.product(range(n_prompts), PENALTIES, TOP_KS, thresholds)
    ]


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def flat(tree, prefix=""):
    """The leaves of a nested dict of tensors, by dotted name."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def serve_study(cfg, params, prompts, *, cache_bytes, expected, launches, silent, sa_serve):
    """Phases 8 and 12: the 36-set SA-serve study through ``run_sa_serve``
    on the card, thresholds from a pilot generation, every task timed
    between syncs. ``expected``: the JAX planner's counts; ``launches``:
    {kernel: (its LaunchCount, launches the study must make)}, counted from
    0 just before the study; ``silent``: {kernel: LaunchCount} that must
    stay at 0. Returns the study's result with the counts under
    ``"launches"``."""
    max_len = next(iter(prompts.values())).shape[1] + GEN_LEN
    pilot = sa_serve.build_serve_stage(cfg, params, prompts, gen_len=GEN_LEN, max_len=max_len)
    cache_b = pilot.tasks[0].output_bytes
    check(cache_b == cache_bytes, f"cache bytes {cache_b} == {cache_bytes:,}")
    # thresholds inside the confidences this model produces: quartiles of a
    # pilot generation (at random init a token's confidence is near 1/vocab)
    pstate = pilot.tasks[0].fn({}, prompt_id=0)
    conf = torch.cat([pilot.tasks[1].fn(pstate, rep_penalty=rp, top_k=TOP_KS[0])["conf"].ravel()
                      for rp in PENALTIES]).cpu().numpy()
    thresholds = [float(q) for q in np.quantile(conf, [0.25, 0.5, 0.75])]
    print(f"pilot confidences: min {conf.min():.6g}, max {conf.max():.6g}; "
          f"thresholds {[f'{t:.6g}' for t in thresholds]}")
    del pstate
    sets = serve_grid(len(prompts), thresholds)
    budget = 3 * cache_b
    task_s = collections.Counter()
    task_n = collections.Counter()

    def timed_task(name, fn):
        @functools.wraps(fn)
        def run(state, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state, **kw)
            torch.cuda.synchronize()
            task_s[name] += time.perf_counter() - t
            task_n[name] += 1
            return out
        return run

    build_stage = sa_serve.build_serve_stage

    def timed_stage(*a, **kw):
        stage = build_stage(*a, **kw)
        return dataclasses.replace(stage, tasks=tuple(
            dataclasses.replace(t, fn=timed_task(t.name, t.fn)) for t in stage.tasks))

    sa_serve.build_serve_stage = timed_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in [c for c, _ in launches.values()] + list(silent.values()):
        counter.reset()
    t0 = time.perf_counter()
    try:
        out = sa_serve.run_sa_serve(cfg, params, prompts, sets, gen_len=GEN_LEN, max_len=max_len,
                                    hbm_budget_bytes=budget, policy="rmsr")
        torch.cuda.synchronize()
    finally:
        sa_serve.build_serve_stage = build_stage
    wall = time.perf_counter() - t0
    counts = {name: c.value for name, (c, _) in launches.items()}
    print(f"sets {len(sets)} ({len(prompts)} prompts x rep_penalty {PENALTIES} x top_k {TOP_KS} "
          f"x 3 thresholds); hbm_budget_bytes {budget}")
    print(f"wall {wall:.3f} s; tasks_total {out['tasks_total']}; planned tasks_executed "
          f"{out['planned_tasks_executed']}; measured tasks_executed {out['tasks_executed']}; "
          f"reuse_fraction {out['reuse_fraction']}; active_paths {out['active_paths']}; "
          f"peak_bytes {out['peak_bytes']}; cache_hits {out['cache_hits']}")
    for key, want in expected.items():
        check(out[key] == want, f"{key} {out[key]} == {want} (the JAX planner's count)")
    for name, (_, want) in launches.items():
        check(counts[name] == want, f"{name} launches {counts[name]} == {want}")
    for name, counter in silent.items():
        check(counter.value == 0, f"no {name} launch in the serve study")
    rates = out["accept_rate"]
    check(len(rates) == len(sets) and all(0.0 <= r <= 1.0 for r in rates.values()),
          "an accept rate in [0, 1] for every set")
    check(len(set(rates.values())) > 1, "accept rates differ across the grid")
    gen_tokens = task_n["generate"] * GEN_LEN
    print("launches in the study: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    print(f"generated tokens {gen_tokens}: {gen_tokens / task_s['generate']:.3f} tokens/s over "
          f"the generate tasks, {gen_tokens / wall:.3f} tokens/s over the wall")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print("per-task seconds (each timed between syncs):")
    for name in task_s:
        print(f"  {name}: {task_n[name]} tasks, {task_s[name]:.3f} s")
    print("accept rates " + " ".join(f"{rates[i]:.4f}" for i in range(len(sets))))
    # reuse changes no result: set 0 run on its own through the stage's tasks
    state, d = {}, dict(sets[0])
    for t in pilot.tasks:
        state = t.fn(state, **{k: d[k] for k in t.param_names})
    check(float(state["accept_rate"]) == rates[0], "set 0 alone == set 0 in the merged study")
    print(f"set 0 on its own: accept rate {float(state['accept_rate'])} (equal)")
    out["launches"] = counts
    return out


def card_vs_cpu(rcfg, sa_serve, init_params, prefill):
    """Phases 9 and 13: the same serve study code and prefill on the card
    and on the CPU, on a reduced model with the same parameters."""
    cpu_params = init_params(rcfg, 0, device="cpu")
    card_params = to_device(cpu_params, "cuda:0")
    rng = np.random.default_rng(1)
    rprompts = {pid: rng.integers(0, rcfg.vocab_size, (1, 16)).astype(np.int32) for pid in range(2)}
    rsets = serve_grid(2, thresholds=(3.7e-3, 4.0e-3))
    kw = dict(gen_len=4, max_len=20)
    card = sa_serve.run_sa_serve(rcfg, card_params, rprompts, rsets, **kw)
    cpu = sa_serve.run_sa_serve(rcfg, cpu_params, rprompts, rsets, **kw)
    for key in ("tasks_total", "tasks_executed", "planned_tasks_executed", "peak_bytes"):
        check(card[key] == cpu[key], f"{key}: card {card[key]} == cpu {cpu[key]}")
    toks = {"tokens": torch.from_numpy(rprompts[0])}
    lc, cc, _ = prefill(rcfg, card_params, toks, max_len=20)
    lp, cp, _ = prefill(rcfg, cpu_params, toks, max_len=20)
    logit_err = float((lc.cpu() - lp).abs().max())
    fc, fp = flat(cc), flat(cp)
    rel = {k: float((fc[k].cpu().float() - fp[k].float()).norm() / fp[k].float().norm())
           for k in fp}
    # bf16: cuBLAS and the CPU round some products to the other neighbour,
    # and random weights amplify that over the layers (as between the port
    # and the JAX package on the CPU, tests/test_torch_models.py)
    check(logit_err <= 0.05, f"prefill logits card vs CPU: max abs diff {logit_err} <= 0.05")
    for k, r in rel.items():
        check(r <= 0.03, f"cached {k} card vs CPU: relative difference {r} <= 0.03")
    differ = sum(card["accept_rate"][i] != cpu["accept_rate"][i] for i in range(len(rsets)))
    print(f"tasks equal ({card['tasks_total']}/{card['tasks_executed']}); prefill logits max abs "
          f"diff {logit_err}; cache relative diff "
          + ", ".join(f"{k} {r}" for k, r in rel.items())
          + f"; accept rates differ in {differ} of {len(rsets)} sets")


def two_streams(morph_recon, mk, ms, reps):
    """Phase 14's concurrency check: ``reps`` calls of the cooperative
    kernel one after another, then the same calls from two threads each on
    its own stream at once (the dataset study's two workers may launch
    together). Every result equals the plain version; no launch waits on
    another's blocks (each thread is joined within a minute); the launch
    count is exact and the rounds and tile visits, which the kernels add
    on the card, hold every call's share."""
    counts = (morph_recon.LAUNCHES, morph_recon.ROUNDS, morph_recon.TILE_VISITS,
              morph_recon.HOST_ROUND_TRIPS)
    th, tw = morph_recon.TILE
    n_tiles = -(-mk.shape[0] // th) * -(-mk.shape[1] // tw)
    want = morph_recon.morph_reconstruct_ref(mk, ms, conn=8)
    torch.cuda.synchronize()
    before = [c.value for c in counts]
    t0 = time.perf_counter()
    serial_out = [morph_recon.morph_reconstruct_cuda(mk, ms, conn=8) for _ in range(reps)]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    serial = [c.value - b for c, b in zip(counts, before)]
    check(all(torch.equal(g, want) for g in serial_out), "serial calls equal the plain version")
    del serial_out
    results = [[], []]

    def worker(slot):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            results[slot] = [morph_recon.morph_reconstruct_cuda(mk, ms, conn=8)
                             for _ in range(reps // 2)]
        stream.synchronize()

    before = [c.value for c in counts]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    check(not any(t.is_alive() for t in threads), "both streams' launches returned within 60 s")
    torch.cuda.synchronize()
    both_s = time.perf_counter() - t0
    both = [c.value - b for c, b in zip(counts, before)]
    got = results[0] + results[1]
    check(len(got) == reps and all(torch.equal(g, want) for g in got),
          "every call from the two streams equals the plain version")
    check(both[0] == serial[0] == reps, f"launches: two streams {both[0]}, serial {serial[0]}, "
          f"calls {reps}")
    check(both[3] == serial[3] == 0, "no host round trip")
    for name, c in (("serial", serial), ("two streams", both)):
        check(c[1] >= reps and c[2] >= reps * n_tiles,
              f"{name}: rounds {c[1]} >= {reps} calls and tile visits {c[2]} >= "
              f"{reps} x {n_tiles} tiles")
    print(f"morph_recon, Seg2 input {tuple(mk.shape)} conn 8, {reps} calls: one after another "
          f"{serial_s:.4f} s ({serial[0]} launches, {serial[1]} rounds, {serial[2]} tile visits); "
          f"two threads on two streams {both_s:.4f} s ({both[0]} launches, {both[1]} rounds, "
          f"{both[2]} tile visits); all equal to the plain version, no host round trip")


def print_task_seconds(task_s, task_n):
    print("per-task seconds (each timed between syncs; with two workers the intervals overlap):")
    for name in task_s:
        print(f"  {name}: {task_n[name]} tasks, {task_s[name]:.3f} s")


def dataset_study(pipeline, tiles, sets, study_dice, counters, timers):
    """Phase 14: ``run_dataset_study`` on the card with its defaults (hybrid,
    two thread workers); returns the kernel's launches in it."""
    task_s, task_n, task_lock, task_streams = timers
    with task_lock:
        task_s.clear()
        task_n.clear()
        task_streams.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    ds = pipeline.run_dataset_study(tiles, sets, strategy="hybrid", n_workers=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, rounds, visits, trips = (c.value for c in counters)
    n = len(tiles)
    _, one, _ = pipeline._plan_image_study(
        SIZE, SIZE, sets, strategy="hybrid", max_bucket_size=None, active_paths=None,
        costs=None, n_workers=2, memory_budget_bytes=None)
    print(f"wall {wall:.3f} s (run_dataset_study's own {ds['wall_seconds']:.3f} s); tiles {n}; "
          f"runs {len(sets)}; backend {ds['backend']}; manager sessions {ds['manager_sessions']}")
    print(f"tasks_total {ds['tasks_total']}; planned tasks_executed {ds['planned_tasks_executed']}; "
          f"measured tasks_executed {ds['tasks_executed']}; single-tile plan {one.tasks_total} / "
          f"{one.tasks_executed}")
    print(f"cache hits {ds['cache_hits']}, misses {ds['cache_misses']}, spills {ds['cache_spills']}; "
          f"reuse_factor {ds['reuse_factor']}")
    print(f"throughput {ds['throughput']} tiles/s; parallel efficiency "
          f"{ds['parallel_efficiency']}; retries {ds['retries']}; backups launched "
          f"{ds['backups_launched']}; dispatch {ds['dispatch_counts']}")
    print(f"morph_recon in the study: {launches} launches, {rounds} rounds, {visits} tile visits, "
          f"{trips} host round trips in the wrapper")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for i, row in enumerate(ds["dice"]):
        print(f"dice tile {i}: " + " ".join(f"{d:.6f}" for d in row))
    print_task_seconds(task_s, task_n)
    print(f"CUDA streams the tasks ran on: {sorted(task_streams)} (0 is the legacy default "
          "stream)")
    check(ds["tasks_total"] == n * one.tasks_total,
          f"tasks_total {ds['tasks_total']} == {n} x {one.tasks_total}")
    check(ds["planned_tasks_executed"] == n * one.tasks_executed,
          f"planned tasks_executed {ds['planned_tasks_executed']} == {n} x {one.tasks_executed}")
    # the winning attempt of each bucket reports its executions and hits
    check(ds["tasks_executed"] + ds["cache_hits"] == ds["planned_tasks_executed"],
          f"executed {ds['tasks_executed']} + hits {ds['cache_hits']} == planned "
          f"{ds['planned_tasks_executed']}")
    check(ds["dice"][0][:len(study_dice)] == study_dice,
          "tile 0's Dice list == phase 4's (same tile, same runs)")
    check(all(row[-1] == 1.0 for row in ds["dice"]), "the default set's Dice is 1.0 on every tile")
    check(all(0.0 <= d <= 1.0 for row in ds["dice"] for d in row), "dice in [0, 1]")
    check(launches > 0 and trips == 0, f"morph_recon launched ({launches}) with no host round trip "
          f"({trips})")
    return launches, ds


def process_dataset_study(pipeline, tiles, sets, ds14, counters):
    """Phase 16: phase 14's study through ``backend="process"``: two spawn
    workers, each rebuilding the study on its own card context. Per-tile
    Dice == phase 14's, planned counts equal, the workers on the card and
    launching ``morph_recon``. Returns {path: launches}: the workers' (from
    their reports) and the leader's (its in-process reference runs)."""
    for c in counters:
        c.reset()
    with WorkerWatch(pipeline) as watch:
        t0 = time.perf_counter()
        ds = pipeline.run_dataset_study(tiles, sets, strategy="hybrid", n_workers=2,
                                        backend="process")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    leader = counters[0].value
    print(f"wall {wall:.3f} s (phase 14, thread workers: {ds14['wall_seconds']:.3f} s); backend "
          f"{ds['backend']}; manager sessions {ds['manager_sessions']}")
    print(f"tasks_total {ds['tasks_total']}; planned tasks_executed {ds['planned_tasks_executed']}; "
          f"measured tasks_executed {ds['tasks_executed']}; cache hits {ds['cache_hits']}; "
          f"leases' busy seconds (as the leader saw them; the task timers wrap the leader's "
          f"functions, not the workers') {ds['stream'].busy_seconds:.3f}; "
          f"throughput {ds['throughput']} tiles/s; parallel efficiency "
          f"{ds['parallel_efficiency']}; retries {ds['retries']}; backups launched "
          f"{ds['backups_launched']}; dispatch {ds['dispatch_counts']}")
    workers = watch.report(2, each_launches=True)
    print(f"morph_recon: {workers} launches in the workers, {leader} in the leader (the "
          f"reference runs); leader max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for i, row in enumerate(ds["dice"]):
        print(f"dice tile {i}: " + " ".join(f"{d:.6f}" for d in row))
    check(ds["backend"] == "process", f"backend {ds['backend']} == process")
    check(ds["dice"] == ds14["dice"], "every tile's Dice list == phase 14's")
    for key in ("tasks_total", "planned_tasks_executed"):
        check(ds[key] == ds14[key], f"{key} {ds[key]} == phase 14's {ds14[key]}")
    check(ds["tasks_executed"] + ds["cache_hits"] == ds["planned_tasks_executed"],
          "executed + hits == planned")
    return {"run_dataset_study(process), workers": workers,
            "run_dataset_study(process), leader": leader}


def socket_study(pipeline, tile, sets, study_dice, study_wall, counters):
    """Phase 17: phase 4's study through ``backend="socket"`` (two workers
    dialling the leader over loopback TCP, the store a plain temporary
    directory), then again with one worker SIGKILLed while it holds a
    lease. Dice == phase 4's both times. Returns {path: launches}."""
    out = {}
    for kill in (False, True):
        for c in counters:
            c.reset()
        with WorkerWatch(pipeline, kill_after=1 if kill else None) as watch:
            t0 = time.perf_counter()
            st = pipeline.run_study(tile, sets, strategy="rmsr", n_workers=2, backend="socket")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        name = "SIGKILL" if kill else "clean"
        print(f"[{name}] wall {wall:.3f} s (phase 4, one thread worker: {study_wall:.3f} s); "
              f"tasks_total {st['tasks_total']}; planned {st['planned_tasks_executed']}; "
              f"measured tasks_executed {st['tasks_executed']}; dispatch {st['dispatch_counts']}")
        if kill:
            print(f"[{name}] worker pid {watch.killed} SIGKILLed holding a lease; leases handed "
                  f"back to the Manager (re-enqueued): {watch.reenqueued}; disconnects "
                  f"{watch.backend.stats()['leader']['disconnects']}")
            check(watch.killed is not None, "a worker was SIGKILLed mid-study")
        workers = watch.report(2, each_launches=False)
        check(st["backend"] == "socket", f"backend {st['backend']} == socket")
        check(st["dice"] == study_dice, f"[{name}] Dice == phase 4's")
        check(st["tasks_total"] == 128 and st["planned_tasks_executed"] == 71,
              f"[{name}] planned counts 128 / 71")
        out[f"run_study(socket, {name}), workers"] = workers
        out[f"run_study(socket, {name}), leader"] = counters[0].value
    return out


def fleet_study(pipeline, counters, timers):
    """Phase 18: ``run_fleet_study`` (two spawned StudyDriver processes over
    one store directory) against one in-process StudyDriver over the same
    ``pathology_fleet_build`` on the card: evaluated objectives and every
    round's records equal, best equal, no corrupt read, fewer combined
    tasks than two independent studies. The single driver's cache holds
    the whole study (no spill to disk, about 100 s at 4096²), which changes
    no objective and only lowers its task count. Returns {path: launches}."""
    from repro_torch.engine import ClusterSpec
    from repro_torch.study import StudyDriver, StudyState

    for c in counters:
        c.reset()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        t0 = time.perf_counter()
        fl = pipeline.run_fleet_study(n_procs=2, store_dir=f"{tmp}/store", size=SIZE, n_tiles=1,
                                      max_rounds=2)
        fleet_s = time.perf_counter() - t0
        used = sum(f.stat().st_size for f in pathlib.Path(tmp).rglob("*") if f.is_file())
    leader = counters[0].value
    fleet = fl["fleet"]
    print(f"fleet wall {fleet_s:.3f} s; rounds {[r['kind'] for r in fl['rounds_detail']]}; tasks "
          f"requested {fl['tasks_requested']}, executed {fl['tasks_executed']} (reuse factor "
          f"{fl['reuse_factor']}); store {used / 2**30:.3f} GiB")
    print(f"fleet stats: { {k: v for k, v in fleet.items() if k != 'build'} }")
    print(f"fleet workers' report (summed over them): {fleet['build']}; leader launches {leader}")
    for r in fl["rounds_detail"]:
        print(f"  {r['kind']}: {json.dumps(r)}")
    task_s, task_n, task_lock, _ = timers
    with task_lock:
        task_s.clear()
        task_n.clear()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    b = pipeline.pathology_fleet_build(size=SIZE, n_tiles=1)
    drv = StudyDriver(b["workflow"], b["space"], b["inputs"], objective=b["objective"], seed=0,
                      n_boot=16, engine_policy="hybrid", cluster=ClusterSpec(n_workers=1),
                      input_keys=b["input_keys"],
                      state=StudyState(b["space"], seed=0, cache_bytes=64 << 30))
    try:
        single = drv.run(max_rounds=2)
    finally:
        drv.close()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    print(f"single-process driver: wall {single_s:.3f} s (its build included); tasks executed "
          f"{single.tasks_executed}; morph_recon launches {counters[0].value}")
    print_task_seconds(task_s, task_n)
    state = fl["state"]
    check(state.evaluated == single.evaluated, "evaluated objectives equal")
    check(len(state.rounds) == len(single.rounds) == 2, "two rounds each way")
    for fr, sr in zip(state.rounds, single.rounds):
        for key in ("kind", "param_sets", "outputs", "analysis", "decision"):
            check(getattr(fr, key) == getattr(sr, key), f"{fr.kind} round: {key} equal")
    want_best = {"params": dict(single.best[0]), "objective": single.best[1]}
    check(fl["best"] == want_best, f"best {fl['best']} == {want_best}")
    check(fleet["corrupt"] == 0, f"corrupt reads {fleet['corrupt']} == 0")
    check(0 < fleet["tasks_executed"] < 2 * single.tasks_executed,
          f"0 < fleet tasks {fleet['tasks_executed']} < 2 x {single.tasks_executed}")
    build = fleet["build"]
    check(build.get("on_cuda") == 2 and build.get("cuda_context") == 2,
          f"both fleet workers on the card with a CUDA context: {build}")
    check(build.get("morph_recon_launches", 0) > 0, "morph_recon launched in the fleet workers")
    print(f"fleet == single-process driver: objectives, round records and best equal; best "
          f"{fl['best']}")
    return {"run_fleet_study, workers": build["morph_recon_launches"],
            "run_fleet_study, leader": leader, "single-process driver": counters[0].value}


def service_build() -> dict:
    """``--build chip_smoke:service_build`` for phase 19's server process:
    the pathology service build at SIZE², one tile, on the card. When the
    process exits it prints where it ran, its ``morph_recon`` launches and
    whether it had to compile the kernel (``build_seconds`` is None when it
    loaded the library that phase 1 built)."""
    import atexit

    from repro_torch.app.pipeline import pathology_service_build
    from repro_torch.kernels import morph_recon

    built = pathology_service_build(size=SIZE, n_tiles=1)
    dev = built["inputs"][0]["raw"].device
    lib = morph_recon.build()

    def report():
        print("service build report: " + json.dumps({
            "cuda_available": torch.cuda.is_available(),
            "device": str(dev),
            "morph_recon_launches": morph_recon.LAUNCHES.value,
            "build_seconds": lib.seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        }), flush=True)

    atexit.register(report)
    return built


def plain_floats(result: dict) -> bool:
    """The job's payload holds Python floats, never a tensor."""
    return (all(type(v) is float for row in result["per_input"] for v in row)
            and all(type(v) is float for v in result["objective"]))


def service_phase(pipeline, sets, counters):
    """Phase 19: the study service (``repro_torch.service``) over the
    pathology build at SIZE², one tile, two thread workers on the card:
    (a) an explicit job with phase 4's runs gives ``1 - Dice`` of
    ``run_study`` on the same tile exactly; (b) a solo MOAT job, then two
    tenants submitting one MOAT spec at once, executed once; (c) a grid job
    cancelled while running; (d) device memory back within the build, the
    shared cache and 64 MiB; (e) ``python -m repro_torch.service serve`` as
    a process answering two TCP tenants with the in-process result.
    Returns {path: launches}."""
    from repro_torch.engine.types import DEFAULT_CACHE_BYTES
    from repro_torch.service import ServiceClient, StudyServer, StudySpec

    metrics = ["objective", "per_input"]
    tile = pipeline.synthetic_tile(SIZE, SIZE, seed=0)
    t0 = time.perf_counter()
    dice = pipeline.run_study(tile, sets)["dice"]
    print(f"run_study on synthetic_tile({SIZE}, {SIZE}, seed=0), phase 4's {len(sets)} runs: "
          f"{time.perf_counter() - t0:.3f} s")
    del tile
    gc.collect()
    torch.cuda.empty_cache()
    for c in counters:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = StudyServer.from_build(pipeline.pathology_service_build, {"size": SIZE, "n_tiles": 1},
                                 n_workers=2)
    torch.cuda.synchronize()
    gc.collect()
    after_build = torch.cuda.memory_allocated()
    print(f"server built: {time.perf_counter() - t0:.3f} s; memory_allocated after the build "
          f"{after_build / 2**20:.1f} MiB; cache_bytes {DEFAULT_CACHE_BYTES >> 20} MiB")

    def run(tenant, spec):
        t = time.perf_counter()
        snap = srv.result(srv.submit(tenant, spec), wait=True, timeout=900)
        check(snap["state"] == "DONE", f"{tenant}'s job DONE: {snap['state']} {snap['error']}")
        return snap, time.perf_counter() - t

    def dispatched():
        return sum(srv.manager.dispatch_counts.values())

    try:
        # (a) exact against the library path
        a, wall = run("lab", StudySpec(sampler="explicit", param_sets=[dict(ps) for ps in sets],
                                       metrics=metrics))
        res = a["result"]
        check(res["per_input"] == [[1 - d] for d in dice],
              "per_input == 1 - Dice of run_study, run by run (==)")
        check(plain_floats(res), "the payload holds Python floats only")
        rec = srv.registry.get(a["job_id"])
        print(f"(a) explicit job, {res['n_runs']} runs: wall {wall:.3f} s; tasks_executed "
              f"{res['tasks_executed']}, cache_hits {res['cache_hits']}, cache_misses "
              f"{res['cache_misses']}; result_bytes {rec.result_bytes}; per_input == 1 - Dice "
              f"for every run")
        two = StudySpec(sampler="explicit", param_sets=[dict(sets[0]), dict(sets[5])],
                        metrics=metrics)
        two_res, wall = run("lab", two)
        two_res = two_res["result"]
        print(f"two-run explicit job (phase (e)'s spec): wall {wall:.3f} s; objective "
              f"{two_res['objective']}")

        # (b) executes once
        d0 = dispatched()
        solo, solo_wall = run("solo", StudySpec(sampler="moat", n_trajectories=1, seed=3))
        single = dispatched() - d0
        shared = StudySpec(sampler="moat", n_trajectories=1, seed=11)
        d1 = dispatched()
        t = time.perf_counter()
        ja, jb = srv.submit("alice", shared), srv.submit("bob", shared)
        ra = srv.result(ja, wait=True, timeout=900)
        rb = srv.result(jb, wait=True, timeout=900)
        shared_wall = time.perf_counter() - t
        combined = dispatched() - d1
        check(ra["state"] == rb["state"] == "DONE", f"alice {ra['state']}, bob {rb['state']}")
        check(ra["result"]["objective"] == rb["result"]["objective"], "alice's == bob's objective")
        check(combined < 2 * single, f"combined {combined} < 2 x single {single}")
        print(f"(b) solo MOAT job ({solo['result']['n_runs']} runs): wall {solo_wall:.3f} s, "
              f"single {single} dispatches; alice + bob, one MOAT spec at once: shared wall "
              f"{shared_wall:.3f} s, combined {combined} dispatches; objectives equal")

        # (c) cancellation
        sweep = StudySpec(sampler="grid", names=["T1", "G1"],
                          bounds={"T1": [2.5, 3.0, 3.5, 4.0], "G1": [5, 10, 15, 20]})
        job = srv.submit("hog", sweep)
        deadline = time.monotonic() + 120
        while srv.status(job)["state"] == "QUEUED":
            check(time.monotonic() < deadline, "the sweep started within 120 s")
            time.sleep(0.005)
        t = time.perf_counter()
        srv.cancel(job)
        while (srv.status(job)["state"] != "CANCELLED"
               or srv.manager.scheduler_stats()["tenant_depths"]):
            check(time.monotonic() < deadline, "the cancel freed the pool within 120 s")
            time.sleep(0.005)
        latency = time.perf_counter() - t
        check(latency < 30.0, f"cancel latency {latency:.3f} s < 30 s")
        print(f"(c) 4x4 grid job cancelled while running: {latency:.3f} s until CANCELLED and "
              f"no queued work")

        # (d) device memory returns
        bound = after_build + DEFAULT_CACHE_BYTES + (64 << 20)
        states = {j["state"] for j in srv.list_jobs()}
        check(states <= {"DONE", "CANCELLED"}, f"every job terminal: {states}")
        t = time.perf_counter()
        while True:  # a poisoned lease's task runs on to its end, then lets go
            gc.collect()
            now = torch.cuda.memory_allocated()
            if now <= bound or time.perf_counter() - t > 60:
                break
            time.sleep(0.5)
        check(now <= bound, f"memory_allocated {now / 2**20:.1f} MiB <= build + cache + 64 MiB "
              f"= {bound / 2**20:.1f} MiB")
        print(f"(d) memory_allocated {now / 2**20:.1f} MiB (bound {bound / 2**20:.1f} MiB) "
              f"{time.perf_counter() - t:.3f} s after the last job; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"server stats: cache {srv.stats()['cache']}; registry {srv.registry.stats()}")
    finally:
        srv.close()
    in_process = counters[0].value
    print(f"morph_recon launches in process (build and jobs): {in_process}")
    check(in_process > 0, "the in-process service launched morph_recon")

    # (e) the TCP entry point
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "serve", "--addr", "127.0.0.1:0",
         "--workers", "2", "--build", "chip_smoke:service_build"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    log = []
    try:
        addr = None
        while addr is None and time.perf_counter() - t < 300:
            try:
                ln = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None:  # it exited, and the reader has put every line
                    break
                continue
            log.append(ln.rstrip())
            if ln.startswith("repro_torch.service listening on "):
                addr = ln.split(" on ", 1)[1].strip()
        check(addr is not None, "the server printed its address: " + " | ".join(log[-20:]))
        print(f"(e) server process up in {time.perf_counter() - t:.3f} s at {addr}")
        t = time.perf_counter()
        tenants = [ServiceClient(addr, name) for name in ("alice", "bob")]
        try:
            jobs = [c.submit(two) for c in tenants]
            wire = [c.result(j, timeout=900, poll_s=0.05) for c, j in zip(tenants, jobs)]
        finally:
            for c in tenants:
                c.close()
        wire_wall = time.perf_counter() - t
        for name, snap in zip(("alice", "bob"), wire):
            check(snap["state"] == "DONE", f"{name}'s TCP job DONE: {snap['error']}")
            for key in ("per_input", "objective", "signature"):
                check(snap["result"][key] == two_res[key], f"{name}'s {key} == in process's")
            check(plain_floats(snap["result"]), f"{name}'s wire payload holds floats only")
        print(f"two TCP tenants, the two-run spec: wall {wire_wall:.3f} s; both equal the "
              f"in-process result")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        while not lines.empty():
            log.append(lines.get().rstrip())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0, f"the server exited 0 on SIGINT (exit {rc}): " + " | ".join(log[-20:]))
    reports = [ln for ln in log if ln.startswith("service build report: ")]
    check(len(reports) == 1, "the server process printed its build report")
    report = json.loads(reports[0].split(": ", 1)[1])
    print(f"server process: {report}; exit {rc} on SIGINT")
    check(report["cuda_available"] and report["device"].startswith("cuda"),
          "the server process ran on the card")
    check(report["morph_recon_launches"] > 0, "the server process launched morph_recon")
    check(report["build_seconds"] is None, "the server process loaded the built kernel")
    return {"service, in process": in_process,
            "service, TCP server process": report["morph_recon_launches"]}


def adaptive_study(pipeline, tiles, counters, timers):
    """Phase 15 at SIZE²: ``run_adaptive_study`` over an ``obj:`` store,
    then the study resumed from its saved state. Returns the kernel's
    launches in the study."""
    from repro_torch.core import dice
    from repro_torch.engine import ClusterSpec, execute_study, plan_study
    from repro_torch.study import StudyDriver, StudyState

    task_s, task_n, task_lock, _ = timers
    with task_lock:
        task_s.clear()
        task_n.clear()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        store_dir = f"obj:{tmp}/store"
        print(f"store {store_dir}: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB free")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        ad = pipeline.run_adaptive_study(tiles, store_dir=store_dir, **ADAPTIVE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, rounds, visits, trips = (c.value for c in counters)
        state = ad["state"]
        kinds = [r.kind for r in state.rounds]
        print(f"wall {wall:.3f} s (run_adaptive_study's own {ad['wall_seconds']:.3f} s, after the "
              f"reference runs); tiles {len(tiles)}; {ADAPTIVE}; rounds {kinds}")
        for r in ad["rounds_detail"]:
            print(f"  {r['kind']}: {json.dumps(r)}")
        print(f"active {ad['active']}; best {ad['best']}")
        print(f"tasks requested {ad['tasks_requested']}, executed {ad['tasks_executed']}; "
              f"reuse_factor {ad['reuse_factor']}; cache hits {ad['cache_hits']}, misses "
              f"{ad['cache_misses']}, spills {ad['cache_spills']}, rehydrations "
              f"{ad['cache_rehydrations']}; store disk hits {ad['store_disk_hits']}; flushed "
              f"{ad['cache_flushed']}")
        print(f"morph_recon in the study: {launches} launches, {rounds} rounds, {visits} tile "
              f"visits, {trips} host round trips in the wrapper")
        print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print_task_seconds(task_s, task_n)
        check(kinds[:2] == ["moat", "vbd"], f"rounds start MOAT, VBD: {kinds}")
        check(ad["tasks_executed"] > 0 and launches > 0 and trips == 0,
              f"morph_recon launched ({launches}) with no host round trip ({trips})")

        # resume: the saved state and a fresh driver over the same store
        ckpt = f"{tmp}/state.json"
        t0 = time.perf_counter()
        state.save(ckpt)
        save_s = time.perf_counter() - t0
        used = sum(f.stat().st_size for f in pathlib.Path(tmp).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        st2 = StudyState.load(ckpt)
        check(st2.store.disk_dir == store_dir, f"the resumed store is {store_dir}")
        raws = [{"raw": torch.from_numpy(t).cuda()} for t in tiles]
        refs = [torch.from_numpy(m).cuda() for m in ad["reference_masks"]]

        def objective(leaf, i):
            return 1.0 - float(dice(leaf["mask"], refs[i]))

        wf = pipeline.build_workflow(SIZE, SIZE)
        drv = StudyDriver(wf, pipeline.TABLE1_SPACE, raws, objective=objective, state=st2,
                          cluster=ClusterSpec(n_workers=1),
                          input_keys=[f"tile{i}" for i in range(len(tiles))])
        before_tasks = sum(task_n.values())
        for c in counters:
            c.reset()
        try:
            rec1 = st2.rounds[0]
            y, stats = drv.evaluate(rec1.param_sets)
            check(stats["n_new"] == 0 and stats["tasks_executed"] == 0 and y == rec1.outputs,
                  f"round 1's runs recalled: {stats}")
            uniq = list(dict.fromkeys(rec1.param_sets))
            plan = plan_study(wf, uniq, policy="hybrid", active_paths=4)
            st2.epoch += 1
            stream = execute_study(plan, raws, cache=st2.cache, manager=drv._ensure_manager(),
                                   input_keys=drv.input_keys, key_prefix=f"r{st2.epoch}:")
            ys = {ps: sum(objective(stream.outputs[i][rid], i) for i in range(len(tiles)))
                  / len(tiles) for rid, ps in enumerate(uniq)}
            torch.cuda.synchronize()
        finally:
            drv.close()
        resume_s = time.perf_counter() - t0
        ran = sum(task_n.values()) - before_tasks
        masks = [stream.outputs[i][rid]["mask"] for i in range(len(tiles)) for rid in range(len(uniq))]
        print(f"saved in {save_s:.3f} s ({used / 2**30:.3f} GiB in the store directory); resumed "
              f"and round 1's {len(uniq)} runs replayed through the engine in {resume_s:.3f} s: "
              f"tasks executed {stream.tasks_executed}, task calls {ran}, cache hits "
              f"{stream.cache_hits}, rehydrations {st2.cache.rehydrations}, store disk hits "
              f"{st2.store.disk_hits}, cache spills {st2.cache.spills}, store writes that found "
              f"the entry there (dedup_writes) {st2.store.dedup_writes}, morph_recon launches "
              f"{counters[0].value}")
        store_path("a leaf's state", stream.outputs[0][0], st2.store.objstore)
        store_path("normalize's output", pipeline._t_normalize(raws[0]), st2.store.objstore)
        check(stream.tasks_executed == 0 and ran == 0 and counters[0].value == 0,
              "zero recompute on resume")
        check(st2.cache.rehydrations > 0, "the replay rehydrated from the store")
        check(all(m.is_cuda and m.dtype == torch.bool for m in masks),
              "rehydrated masks are bool tensors on the card")
        check(all(ys[ps] == st2.evaluated[ps] for ps in uniq),
              "objectives of the rehydrated masks == the recorded ones")
    return launches


def compute_apps():
    """{pid: used MiB} of the processes ``nvidia-smi`` shows holding a
    context on the card; empty where the tool lists none (a container may
    hide other processes' pids)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30,
    ).stdout
    apps = {}
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps[int(parts[0])] = int(parts[1]) if parts[1].isdigit() else -1
    return apps


class WorkerWatch:
    """Phases 16 and 17: the backend a study entry point builds from its
    ``"process"``/``"socket"`` spec (caught at ``pipeline._backend_for``),
    its worker pids and what ``nvidia-smi`` shows on the card while the
    study runs (sampled every half second), and, with ``kill_after``, one
    worker SIGKILLed while it holds a lease, once ``kill_after`` leases have
    completed in the workers."""

    def __init__(self, pipeline, kill_after=None):
        self.pipeline, self.kill_after = pipeline, kill_after
        self.backend, self.pids, self.apps = None, set(), {}
        self.killed, self.reenqueued = None, 0
        self._stop = threading.Event()

    def __enter__(self):
        build = self.pipeline._backend_for

        def capture(*a, **kw):
            self.backend = build(*a, **kw)
            return self.backend

        self._build, self.pipeline._backend_for = build, capture
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def _watch(self):
        while not self._stop.wait(0.05):
            b = self.backend
            if b is None:
                continue
            self.pids.update(p for p in b.worker_pids() if p)
            if int(time.monotonic() * 20) % 10 == 0:
                for pid, mib in compute_apps().items():
                    self.apps[pid] = max(mib, self.apps.get(pid, 0))
            if self.kill_after is not None and self.killed is None:
                self._maybe_kill(b)

    def _maybe_kill(self, b):
        if b.stats()["worker"].get("leases_run", 0) < self.kill_after:
            return
        view = b.heartbeat_view()
        pids = dict(zip([w for w in view if w >= 0], b.worker_pids()))
        busy = [w for w, st in view.items() if w >= 0 and st.alive and st.inflight]
        if not busy or not pids.get(busy[0]):
            return
        self.killed = pids[busy[0]]
        os.kill(self.killed, signal.SIGKILL)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:  # the leases it held, handed to the Manager
            dead = [st for w, st in b.heartbeat_view().items() if not st.alive]
            if dead:
                self.reenqueued = sum(len(st.inflight) for st in dead)
                return
            time.sleep(0.01)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        self.pipeline._backend_for = self._build

    def report(self, n_workers, *, each_launches):
        """Print the workers' own report (summed over them, from their last
        heartbeats) and check that each held a CUDA context on the card and
        that the kernel ran in them (in each, with ``each_launches``).
        Returns the workers' kernel launches."""
        stats = self.backend.stats()
        w = stats["worker"]
        build = w.get("build", {})
        seen = sorted(set(self.apps) & self.pids)
        print(f"backend {stats['backend']}: {n_workers} spawned workers, pids {sorted(self.pids)}; "
              f"nvidia-smi showed {len(self.apps)} processes on the card during the study "
              f"({sorted(self.apps.items())}), {len(seen)} of them workers {seen}")
        print(f"workers' report (summed over them): {build}; leases run {w.get('leases_run')}, "
              f"plan builds {w.get('plan_builds')}, route counts shm {w.get('shm_sends')} / inline "
              f"{w.get('inline_sends')} / store {w.get('store_sends')}, fetches {w.get('fetches')}; "
              f"workers' caches {w.get('cache')}; stores {w.get('store')}; leader {stats['leader']}")
        lost = 1 if self.killed else 0
        check(build.get("on_cuda", 0) >= n_workers - lost
              and build.get("cuda_context", 0) >= n_workers - lost,
              f"every worker's build is on the card with a CUDA context: {build}")
        check(build.get("morph_recon_launches", 0) > 0, "morph_recon launched in the workers")
        if each_launches:
            check(build.get("launched_morph_recon", 0) == n_workers,
                  f"morph_recon launched in each of the {n_workers} workers: {build}")
        return build.get("morph_recon_launches", 0)


def store_path(what, value, objstore):
    """Where a spill's and a rehydration's time goes: one task state on the
    card through the steps of the object tier, each timed on its own."""
    from repro_torch.runtime import storage

    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        return out

    payload = step("serialise (to the host, npz)", lambda: storage._serialise(value))
    blob = step("footer (sha256)", lambda: storage._pack_entry(payload))
    step("put_if_absent, new key (tmp file, fsync, link)",
         lambda: objstore.put_if_absent("timing/entry", blob))
    step("put_if_absent, key present (tmp file, fsync, EEXIST)",
         lambda: objstore.put_if_absent("timing/entry", blob))
    data = step("get", lambda: objstore.get("timing/entry"))
    body = step("footer check (sha256)", lambda: storage._footer_ok(data))
    step("deserialise (npz, to the card)", lambda: storage._deserialise(body))
    objstore.delete("timing/entry")
    print(f"{what} ({len(blob) / 2**20:.1f} MiB entry) through the object tier: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in steps.items()))


def adaptive_card_vs_cpu(pipeline):
    """Phase 15 at 256²: the same adaptive study on the card and on the
    CPU, round records and outputs equal."""
    small = pipeline.synthetic_tile(256, 256, seed=0)
    t0 = time.perf_counter()
    card = pipeline.run_adaptive_study([small], **ADAPTIVE)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = pipeline.run_adaptive_study([small], device="cpu", **ADAPTIVE)
    cpu_s = time.perf_counter() - t0
    check(card["rounds_detail"] == cpu["rounds_detail"], "round records equal")
    for a, b in zip(card["state"].rounds, cpu["state"].rounds):
        check(a.param_sets == b.param_sets and a.outputs == b.outputs,
              f"{a.kind} round: param sets and objectives equal")
    for key in ("active", "frozen", "best", "tasks_requested", "tasks_executed", "reuse_factor"):
        check(card[key] == cpu[key], f"{key}: card {card[key]} == cpu {cpu[key]}")
    check(all(np.array_equal(a, b) for a, b in zip(card["reference_masks"], cpu["reference_masks"])),
          "reference masks equal")
    print(f"rounds {[r['kind'] for r in card['rounds_detail']]}; tasks {card['tasks_requested']} / "
          f"{card['tasks_executed']}; round records, param sets, objectives, survivors "
          f"{card['active']} and best equal; card {card_s:.3f} s, CPU {cpu_s:.3f} s")


T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name} [{time.perf_counter() - T0:.1f} s into the run]", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_case(h, w, seed):
    """The marker/mask cases of tests/test_kernel_morph_recon.py."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(0, 100, (h, w)).astype(np.float32)
    marker = np.maximum(mask - rng.uniform(5, 40, (h, w)).astype(np.float32), 0)
    for _ in range(max(1, h * w // 256)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        marker[y, x] = mask[y, x]
    return torch.from_numpy(marker).cuda(), torch.from_numpy(mask).cuda()


def recon_inputs(pipeline, tile: np.ndarray) -> dict:
    """The two reconstructions of the default-parameter run on ``tile``, on
    the card, as (marker, mask): Seg2's (gray - G1 under gray) and Seg3's
    fill-holes (the complement of the thresholded residual, from its
    border)."""
    default = dict(pipeline.TABLE1_SPACE.default())
    st = {"raw": torch.from_numpy(tile).cuda()}
    st = pipeline._t_normalize(st)
    st = pipeline._t_background(st, default["B"], default["G"], default["R"])
    st = pipeline._t_rbc(st, default["T1"], default["T2"])
    gray = st["gray"]
    seg2_marker = torch.clamp_min(gray - float(default["G1"]), 0.0)
    residual = pipeline._t_recon(st, default["G1"], default["RC"])["residual"]
    inv = (~(residual > float(default["G2"]) * 0.5)).to(torch.float32)
    border = torch.zeros_like(inv)
    border[0, :], border[-1, :], border[:, 0], border[:, -1] = inv[0, :], inv[-1, :], inv[:, 0], inv[:, -1]
    return {"seg2": (seg2_marker, gray), "fill-holes": (border, inv)}


def mosaic_tile(pipeline, first_seed: int = 0) -> np.ndarray:
    """SIZE² tile as a mosaic of SUB² synthetic tiles with seeds first_seed,
    first_seed + 1, ... in row-major order: the tile of phases 3, 4 and 14
    since the first slice, kept so that their numbers stay comparable
    (phase 18's fleet makes its own ``synthetic_tile(SIZE, SIZE)``)."""
    n = SIZE // SUB
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        subs = list(pool.map(lambda s: pipeline.synthetic_tile(SUB, SUB, seed=s),
                             range(first_seed, first_seed + n * n)))
    rows = [np.concatenate(subs[r * n : (r + 1) * n], axis=1) for r in range(n)]
    return np.concatenate(rows, axis=0)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.app import pipeline
    from repro_torch.core import halton_sequence, morris_trajectories, sa_serve
    from repro_torch.kernels import flash_attention, morph_recon, nvcc, ssm_scan
    from repro_torch.kernels import ref as kref
    from repro_torch.models import init_params, prefill
    from repro_torch.models import model as model_mod, ssm as ssm_mod
    from repro_torch.models.layers import rms_norm

    # -- 1. device --------------------------------------------------------
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind}; count {torch.cuda.device_count()}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    print("tf32: matmul off, cudnn off")
    # one nvcc for each kernel source, started together
    t_build = time.perf_counter()
    build_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    builds = {"morph_recon": build_pool.submit(morph_recon.build),
              "ssm_scan": build_pool.submit(ssm_scan.build),
              "flash_attention": build_pool.submit(flash_attention.build),
              "flash_attention_wgmma": build_pool.submit(flash_attention.build_wgmma)}
    build_pool.shutdown(wait=False)

    def show_build(name):
        build = builds[name].result()
        print(f"{name}: nvcc {' '.join(nvcc.NVCC_FLAGS)}")
        print(f"build seconds: {build.seconds if build.seconds is not None else 'cached'} "
              f"(the builds started {time.perf_counter() - t_build:.3f} s ago)")
        for ln in build.ptxas_info.splitlines():
            if any(w in ln for w in ("registers", "Compiling entry", "smem", "spill")):
                print(ln.strip())

    # -- 2. build ---------------------------------------------------------
    phase("2 build")
    show_build("morph_recon")

    # -- 3. kernel vs plain version --------------------------------------
    phase("3 kernel vs plain version (torch.equal, atol=0)")
    t0 = time.perf_counter()
    tile = mosaic_tile(pipeline)
    print(f"tile {tile.shape} {tile.dtype}: {time.perf_counter() - t0:.1f} s host")

    default = dict(pipeline.TABLE1_SPACE.default())
    cases = {f"random {h}x{w}": random_case(h, w, seed=h + w) for h, w in
             [(65, 33), (1, 1), (31, 1000), (SIZE, SIZE)]}
    for name, case in recon_inputs(pipeline, tile).items():
        cases[f"{name} {SIZE}x{SIZE}"] = case
    max_err = 0.0
    timing = {}
    th, tw = morph_recon.TILE
    check(morph_recon.kernel_tile()[:2] == (th, tw),
          f"the kernel's tile {morph_recon.kernel_tile()[:2]} == TILE {(th, tw)}")
    counters = (morph_recon.LAUNCHES, morph_recon.ROUNDS, morph_recon.TILE_VISITS,
                morph_recon.HOST_ROUND_TRIPS)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # the stream stays busy for some milliseconds
    morph_recon.morph_reconstruct_cuda(*cases["random 65x33"], conn=8)
    check(not torch.cuda.current_stream().query(), "a call returns while the card is busy")
    print("a call returns while the card is still busy: it makes no host round trip")
    for name, (mk, ms) in cases.items():
        for conn in (4, 8):
            torch.cuda.synchronize()
            before = [c.value for c in counters]
            got = morph_recon.morph_reconstruct_cuda(mk, ms, conn=conn)
            launches, rounds, visits, trips = (c.value - b for c, b in zip(counters, before))
            want = morph_recon.morph_reconstruct_ref(mk, ms, conn=conn)
            check(torch.equal(got, want), f"morph_recon == plain on {name} conn={conn} "
                  f"({int((got != want).sum())} pixels differ)")
            check(launches == 1 and trips == 0,
                  f"one launch ({launches}) and no host round trip ({trips}) a call")
            max_err = max(max_err, float((got - want).abs().max()))
            line = f"{name} conn={conn}: equal, {launches} launch, {trips} host round trips"
            if mk.numel() == SIZE * SIZE:
                tiled = morph_recon.morph_reconstruct_tiled(mk, ms, conn, (th, tw))
                check(torch.equal(got, tiled.result),
                      f"morph_recon == the plain tiled schedule on {name} conn={conn}")
                for rep in range(3):  # the visits' order changes from call to call
                    again = morph_recon.morph_reconstruct_cuda(mk, ms, conn=conn)
                    check(torch.equal(again, want), f"repeat {rep} equal on {name} conn={conn}")
                ms_k = cuda_ms(lambda: morph_recon.morph_reconstruct_cuda(mk, ms, conn=conn), 5)
                ms_p = cuda_ms(lambda: morph_recon.morph_reconstruct_ref(mk, ms, conn=conn), 2)
                bound = recon_bound_ms(mk.numel(), conn)
                n_tiles = -(-mk.shape[0] // th) * -(-mk.shape[1] // tw)
                timing[(name, conn)] = (ms_k, ms_p, bound, launches, rounds, visits)
                check(visits < n_tiles * rounds or rounds == 1,
                      f"tile visits {visits} < tiles x rounds {n_tiles * rounds}")
                line += (f"; rounds {rounds}, tile visits {visits} of tiles x rounds "
                         f"{n_tiles} x {rounds} = {n_tiles * rounds} "
                         f"({visits / (n_tiles * rounds):.3f}); plain tiled schedule equal, "
                         f"rounds {tiled.rounds}, tile visits {tiled.tile_visits}; 3 repeats "
                         f"equal; kernel {ms_k:.4f} ms, plain {ms_p:.3f} ms, bound "
                         f"{bound:.4f} ms (bytes), {ms_k / bound:.1f}x bound")
            print(line, flush=True)
    print("kernels: morph_recon")
    print(f"max_abs_err {max_err}")
    print("library call: none (no one PyTorch call computes reconstruction by dilation; "
          "max_pool2d is one dilation step)")
    del cases
    torch.cuda.empty_cache()

    # -- 4. the study ------------------------------------------------------
    phase(f"4 study: run_study on the {SIZE}x{SIZE} tile, MOAT over Table I")
    sets, _ = morris_trajectories(pipeline.TABLE1_SPACE, 1, seed=0)
    sets = sets[:MOAT_RUNS]
    print(f"runs: {len(sets)} of {len(sets)} (MOAT trajectory, seed 0)")
    task_s = collections.Counter()
    task_n = collections.Counter()
    task_lock = threading.Lock()  # phase 14 runs tasks on two worker threads
    task_streams = set()  # the CUDA streams the tasks ran on (phase 14 prints them)

    def timed(name, fn):
        @functools.wraps(fn)
        def run(state, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state, *args, **kw)
            torch.cuda.synchronize()
            with task_lock:
                task_s[name] += time.perf_counter() - t
                task_n[name] += 1
                task_streams.add(torch.cuda.current_stream().cuda_stream)
            return out
        return run

    for name in ("_t_normalize", "_t_background", "_t_rbc", "_t_recon",
                 "_t_threshold", "_t_area_pre", "_t_watershed", "_t_area_final"):
        setattr(pipeline, name, timed(name[3:], getattr(pipeline, name)))

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    out = pipeline.run_study(tile, sets, strategy="rmsr")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    study_launches, study_rounds, study_visits, study_trips = (c.value for c in counters)
    check(out["tasks_total"] == 8 * len(sets) == 128, f"tasks_total {out['tasks_total']} == 128")
    check(out["planned_tasks_executed"] == 71,
          f"planned tasks_executed {out['planned_tasks_executed']} == 71")
    check(all(0.0 <= d <= 1.0 for d in out["dice"]), f"dice in [0, 1]: {out['dice']}")
    check(study_launches > 0, "the study launched morph_recon")
    print(f"wall {wall:.3f} s; tasks_total {out['tasks_total']}; planned tasks_executed "
          f"{out['planned_tasks_executed']}; measured tasks_executed {out['tasks_executed']}; "
          f"cache_hits {out['cache_hits']}; reuse_fraction {out['reuse_fraction']}")
    print(f"morph_recon in the study: {study_launches} launches, {study_rounds} rounds, "
          f"{study_visits} tile visits, {study_trips} host round trips in the wrapper")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print("dice " + " ".join(f"{d:.6f}" for d in out["dice"]))
    print("per-task seconds (tasks of the study and its reference run; each timed between syncs):")
    for name in task_s:
        print(f"  {name}: {task_n[name]} tasks, {task_s[name]:.3f} s")
    ref = pipeline.run_study(tile, [pipeline.TABLE1_SPACE.default()])
    check(ref["dice"] == [1.0], f"default-parameter dice {ref['dice']} == [1.0]")
    print("default-parameter study: dice [1.0]")
    study_dice = out["dice"]  # phases 14 and 17 hold tile 0 of their studies to these
    study_wall = wall
    torch.cuda.empty_cache()

    # -- 5. card vs CPU --------------------------------------------------
    phase("5 card vs CPU at 256x256, 8 Halton sets")
    small = pipeline.synthetic_tile(256, 256, seed=0)
    hsets = pipeline.TABLE1_SPACE.quantise(halton_sequence(8, pipeline.TABLE1_SPACE.dim))
    card = pipeline.run_study(small, hsets)
    cpu = pipeline.run_study(small, hsets, device="cpu")
    for key in ("tasks_total", "tasks_executed", "planned_tasks_executed"):
        check(card[key] == cpu[key], f"{key}: card {card[key]} == cpu {cpu[key]}")
    diff = max(abs(a - b) for a, b in zip(card["dice"], cpu["dice"]))
    # normalize_tile's mean and std reduce in another order on the card,
    # which can move a threshold pixel by one ulp
    check(diff <= 1e-3, f"largest Dice difference {diff} <= 1e-3")
    print(f"tasks equal ({card['tasks_total']}/{card['tasks_executed']}); "
          f"largest Dice difference {diff}")

    # -- 6. build ssm_scan --------------------------------------------------
    phase("6 build")
    show_build("ssm_scan")
    for per_head in (True, False):  # Mamba2's and RWKV-6's prefill: N = P = chunk = 64
        built_smem = tuple(ssm_scan.build().lib.ssm_scan_smem(64, 64, 64, int(per_head), pas)
                           for pas in (0, 1))
        check(built_smem == ssm_scan.shared_memory_bytes(64, 64, 64, per_head),
              f"shared memory of the passes {built_smem} as ssm_scan.shared_memory_bytes says")
        print(f"dynamic shared memory a block ({'per head' if per_head else 'per channel'}): "
              f"state pass {built_smem[0]}, output pass {built_smem[1]} bytes")

    # -- 7. ssm_scan vs its plain versions --------------------------------
    phase("7 ssm_scan vs plain versions (fp32 inputs, rtol = atol = 2e-4; chunk sweep 3e-4)")
    scan_err = 0.0
    cases = [(f"{shape[:5]} {'per-channel' if pc else 'per-head'}",
              scan_case(*shape[:5], pc, seed=shape[1] * 7 + shape[3]), shape[5], 2e-4)
             for shape in SCAN_SHAPES for pc in (False, True)]
    cases.append(("strong decay a=1e-6 (1,48,1,8,8)", strong_decay_case(), 16, 2e-4))
    cases += [(f"chunk sweep S={s_} chunk={ch} {'per-channel' if pc else 'per-head'}",
               scan_case(1, s_, 2, 4, 8, pc, seed), ch, 3e-4) for s_, ch, pc, seed in SCAN_SWEEP]
    for name, (x, a, b, c), chunk, tol in cases:
        before = ssm_scan.LAUNCHES.value
        y, hf = ssm_scan.ssm_scan_cuda(x, a, b, c, chunk=chunk)
        torch.cuda.synchronize()
        check(ssm_scan.LAUNCHES.value == before + 1, f"one launch for {name}")
        check(bool(torch.isfinite(y).all()), f"finite y on {name}")
        errs = []
        for plain, (yp, hp) in (("ref", kref.ssm_scan_ref(x, a, b, c)),
                                ("chunked", kref.ssm_scan_chunked(x, a, b, c, chunk=chunk)),
                                ("three_pass", kref.ssm_scan_three_pass(x, a, b, c, chunk=chunk))):
            check(torch.allclose(y, yp, rtol=tol, atol=tol) and torch.allclose(hf, hp, rtol=tol, atol=tol),
                  f"ssm_scan within {tol} of ssm_scan_{plain} on {name}")
            errs.append(max(float((y - yp).abs().max()), float((hf - hp).abs().max())))
        scan_err = max(scan_err, *errs)
        print(f"{name} chunk={chunk}: max abs err vs ref {errs[0]:.3g}, vs chunked {errs[1]:.3g}, "
              f"vs three_pass {errs[2]:.3g}")
    print(f"max_abs_err {scan_err}")

    cfg = configs.get_config(ARCH)
    rng = np.random.default_rng(0)
    prompts = {pid: rng.integers(0, cfg.vocab_size, (1, PROMPT_LEN)).astype(np.int32)
               for pid in range(PROMPTS)}
    t0 = time.perf_counter()
    params = init_params(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in [params["embed"], params["lm_head"], params["final_norm"],
                                        *params["layers"].values()])
    print(f"{ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.ssm_heads} heads of "
          f"{cfg.ssm_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}); "
          f"{n_params} parameters held (param_count() {cfg.param_count()}), seeded on the card "
          f"in {time.perf_counter() - t0:.3f} s")
    # layer 0's scan inputs from the full-width prefill of prompt 0
    layer0 = {k: v[0] for k, v in params["layers"].items()}
    xe = params["embed"][torch.from_numpy(prompts[0]).cuda().long()].to(torch.bfloat16)
    xa = rms_norm(xe, layer0["ln1"], cfg.norm_eps)
    r, k, v, _, w = ssm_mod._rwkv_project(xa, ssm_mod._token_shift(xa), layer0, cfg)
    real = (v, w, k, r)  # x, a, b, c as rwkv6_block passes them
    print("real shape: x/b/c " + ", ".join(f"{tuple(t.shape)} {t.dtype}" for t in (v, k, r))
          + f"; a {tuple(w.shape)} {w.dtype}")
    scan_ms, scan_plain_ms, scan_3p_ms, scan_bound_ms, scan_bound_by = scan_real_shape(real, 50, 5)
    del real, r, k, v, w, xe, xa, layer0  # layer0's views hold every RWKV-6 layer

    # Mamba2's real shape: layer 0 of the Zamba2 2.7B prefill of prompt 0
    zcfg = configs.get_config(ZAMBA)
    zn_blocks = zcfg.num_layers // zcfg.attn_every
    rng = np.random.default_rng(0)
    zprompts = {pid: rng.integers(0, zcfg.vocab_size, (1, Z_PROMPT_LEN)).astype(np.int32)
                for pid in range(PROMPTS)}
    t0 = time.perf_counter()
    zparams = init_params(zcfg, 0)  # seeded: phase 11 draws the same again
    torch.cuda.synchronize()
    print(f"{ZAMBA}: {zcfg.num_layers} Mamba2 layers ({zcfg.ssm_heads} heads of "
          f"{zcfg.ssm_head_dim}, state {zcfg.ssm_state}), d_model {zcfg.d_model}, one shared "
          f"attention block ({zcfg.num_heads} heads of {zcfg.head_dim}, d_ff {zcfg.d_ff}) applied "
          f"{zn_blocks} times, vocab {zcfg.vocab_size}; "
          f"{sum(t.numel() for t in flat(zparams).values())} parameters held (param_count() "
          f"{zcfg.param_count()}), seeded on the card in {time.perf_counter() - t0:.3f} s")
    zx0 = zparams["embed"][torch.from_numpy(zprompts[0]).cuda().long()]
    p0 = {k_: v_[0, 0] for k_, v_ in zparams["mamba"].items()}
    real, _, _ = ssm_mod.mamba2_scan_inputs(rms_norm(zx0, p0["ln"], zcfg.norm_eps), p0, zcfg)
    print("Mamba2 real shape: x/b/c " + ", ".join(f"{tuple(t.shape)} {t.dtype}" for t in
                                                  (real[0], real[2], real[3]))
          + f"; a {tuple(real[1].shape)} {real[1].dtype} (per head); c's stride over H "
          f"{real[3].stride(2)}")
    m2_ms, m2_plain_ms, m2_3p_ms, m2_bound_ms, m2_bound_by = scan_real_shape(real, 20, 2)
    print(f"Mamba2 shape: {zcfg.num_layers} launches a prefill, "
          f"{zcfg.num_layers * m2_ms:.1f} ms of kernel time")
    print("library call: none (no one PyTorch call computes a gated linear recurrence)")
    del cases, real, p0, zparams, zx0
    torch.cuda.empty_cache()

    # -- 8. the SA-serve study at full width -------------------------------
    phase(f"8 SA-serve study: run_sa_serve on {ARCH} at full width")
    launches = {}
    out = serve_study(cfg, params, prompts, cache_bytes=12_779_520,
                      expected={"tasks_total": 108, "planned_tasks_executed": 51,
                                "tasks_executed": 51, "reuse_fraction": 57 / 108,
                                "active_paths": 2, "peak_bytes": 28_754_048},
                      launches={"ssm_scan": (ssm_scan.LAUNCHES, cfg.num_layers * PROMPTS)},
                      silent={"morph_recon": morph_recon.LAUNCHES,
                              "flash_attention": flash_attention.LAUNCHES,
                              "flash_attention_wgmma": flash_attention.WGMMA_LAUNCHES},
                      sa_serve=sa_serve)
    launches["rwkv6_serve"] = out["launches"]["ssm_scan"]
    del params
    torch.cuda.empty_cache()

    # -- 9. card vs CPU, reduced RWKV-6 -----------------------------------
    phase("9 card vs CPU, reduced RWKV-6")
    card_vs_cpu(configs.reduced_config(cfg), sa_serve, init_params, prefill)

    # -- 10. build flash_attention -----------------------------------------
    phase("10 build")
    show_build("flash_attention")
    built_smem = flash_attention.build().lib.flash_attention_smem(zcfg.head_dim)
    check(built_smem == flash_attention.shared_memory_bytes(zcfg.head_dim),
          "CUDA-core kernel's shared memory as shared_memory_bytes says")
    print(f"dynamic shared memory a block at D = {zcfg.head_dim}: {built_smem} bytes")
    show_build("flash_attention_wgmma")
    built_smem = flash_attention.build_wgmma().lib.flash_attention_wgmma_smem(zcfg.head_dim)
    check(built_smem == flash_attention.wgmma_shared_memory_bytes(zcfg.head_dim),
          "tensor-core kernel's shared memory as wgmma_shared_memory_bytes says")
    print(f"dynamic shared memory a CTA at D = {zcfg.head_dim}: {built_smem} bytes "
          f"({flash_attention.WGMMA_THREADS} threads)")

    # -- 11. flash_attention vs its plain versions -------------------------
    phase("11 flash_attention vs plain versions (fp32 on the CUDA cores, rtol = atol = 2e-5; "
          "bf16 on the tensor cores, one bf16 rounding of the plain version, 2e-2 of the oracle)")
    cases = [(f"causal {c}", qkv_case(c[0], c[1], c[1], *c[2:], seed=c[1] + c[2]), None, 0)
             for c in FA_CAUSAL]
    cases += [(f"window {w}", qkv_case(1, 96, 96, 2, 2, 32, seed=w), w, 0) for w in FA_WINDOWS]
    cases.append(("q_offset 48 (16 queries, 64 keys)", qkv_case(1, 16, 64, 2, 2, 16, seed=9),
                  None, 48))
    cases += [(f"property {pc}", qkv_case(1, pc[0], pc[0], pc[1], pc[1], 16, seed=pc[3]), pc[2], 0)
              for pc in FA_PROPERTY]
    fa_err = 0.0
    for name, (q, k, v), window, q_offset in cases:
        before = flash_attention.LAUNCHES.value
        wgmma_before = flash_attention.WGMMA_LAUNCHES.value
        got = flash_attention.flash_attention_cuda(q, k, v, window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        check(flash_attention.LAUNCHES.value == before + 1
              and flash_attention.WGMMA_LAUNCHES.value == wgmma_before,
              f"one CUDA-core launch for {name}")
        errs = []
        for plain, want in (
            ("attention_ref", kref.attention_ref(q, k, v, window=window)),
            ("flash_attention_blocked",
             kref.flash_attention_blocked(q, k, v, window=window, q_offset=q_offset)),
        ):
            check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
                  f"flash_attention within 2e-5 of {plain} on {name}")
            errs.append(float((got - want).abs().max()))
        fa_err = max(fa_err, *errs)
        print(f"{name}: max abs err vs attention_ref {errs[0]:.3g}, vs blocked {errs[1]:.3g}")
    print(f"max_abs_err (fp32, CUDA cores) {fa_err}")
    fa_bf16_err = 0.0
    for name, qkv, window, q_offset in cases:
        q, k, v = (t.bfloat16() for t in qkv)
        check(kref.uses_tensor_cores(q.dtype, q.shape[3]), f"{name} in bf16 takes the tensor cores")
        before = flash_attention.WGMMA_LAUNCHES.value
        simt_before = flash_attention.LAUNCHES.value
        got = flash_attention.flash_attention_cuda(q, k, v, window=window, q_offset=q_offset)
        torch.cuda.synchronize()
        check(flash_attention.WGMMA_LAUNCHES.value == before + 1
              and flash_attention.LAUNCHES.value == simt_before, f"one tensor-core launch for {name}")
        want = kref.flash_attention_blocked(q, k, v, window=window, q_offset=q_offset)
        check(torch.allclose(got.float(), want.float(), rtol=2 ** -7, atol=2 ** -8),
              f"bf16 {name} within one bf16 rounding of flash_attention_blocked")
        oracle = kref.attention_ref(*(t.float() for t in (q, k, v)), window=window)
        # the oracle aligns the queries at the end of the keys, as q_offset does here
        check(torch.allclose(got.float(), oracle, rtol=2e-2, atol=2e-2),
              f"bf16 {name} within 2e-2 of attention_ref on the same bf16 values")
        errs = (float((got.float() - want.float()).abs().max()),
                float((got.float() - oracle).abs().max()))
        fa_bf16_err = max(fa_bf16_err, *errs)
        print(f"bf16 {name}: max abs err vs blocked {errs[0]:.3g}, vs attention_ref {errs[1]:.3g}")
    print(f"max_abs_err (bf16, tensor cores) {fa_bf16_err}")
    fa_err_bf16_simt = 0.0
    for d in (72, 24):  # bf16 with D not a multiple of 16: the CUDA-core kernel by dispatch
        q, k, v = (t.bfloat16() for t in qkv_case(1, 300, 300, 8, 4, d, seed=d))
        check(not kref.uses_tensor_cores(q.dtype, d), f"bf16 D = {d} takes the CUDA cores")
        before = flash_attention.LAUNCHES.value
        wgmma_before = flash_attention.WGMMA_LAUNCHES.value
        got = flash_attention.flash_attention_cuda(q, k, v, window=120)
        torch.cuda.synchronize()
        check(flash_attention.LAUNCHES.value == before + 1
              and flash_attention.WGMMA_LAUNCHES.value == wgmma_before,
              f"one CUDA-core launch for bf16 D = {d}")
        want = kref.flash_attention_blocked(q, k, v, window=120)  # fp32 arithmetic for such D
        check(torch.allclose(got.float(), want.float(), rtol=2 ** -7, atol=2 ** -9),
              f"bf16 D = {d} within one bf16 rounding of flash_attention_blocked")
        oracle = kref.attention_ref(*(t.float() for t in (q, k, v)), window=120)
        check(torch.allclose(got.float(), oracle, rtol=2e-2, atol=2e-2),
              f"bf16 D = {d} within 2e-2 of attention_ref on the same bf16 values")
        errs = (float((got.float() - want.float()).abs().max()),
                float((got.float() - oracle).abs().max()))
        fa_err_bf16_simt = max(fa_err_bf16_simt, *errs)
        print(f"bf16 D = {d} (1,300,8,4) window 120 on the CUDA cores: max abs err vs blocked "
              f"{errs[0]:.3g}, vs attention_ref {errs[1]:.3g}")
    del cases
    d256 = gemma3_attention(flash_attention, kref)
    torch.cuda.empty_cache()

    # the shared block's first application in the prefill of prompt 0
    zparams = init_params(zcfg, 0)
    x = zparams["embed"][torch.from_numpy(zprompts[0]).cuda().long()]
    positions = torch.arange(Z_PROMPT_LEN, device=x.device)[None]
    for j in range(zcfg.attn_every):
        p = {k_: v_[0, j] for k_, v_ in zparams["mamba"].items()}
        x = x + ssm_mod.mamba2_block(rms_norm(x, p["ln"], zcfg.norm_eps), p, zcfg)
    real = model_mod._attn_qkv(x, zparams["shared_attn"], zcfg, positions)
    print("real shape: q/k/v " + ", ".join(f"{tuple(t.shape)} {t.dtype}" for t in real)
          + "; strides " + ", ".join(str(t.stride()) for t in real))
    before = flash_attention.WGMMA_LAUNCHES.value
    got = flash_attention.flash_attention_cuda(*real)
    torch.cuda.synchronize()
    check(flash_attention.WGMMA_LAUNCHES.value == before + 1, "the real shape takes the tensor cores")
    want = kref.flash_attention_blocked(*real)  # its bf16 arithmetic: P rounded to bf16
    omax = float(want.float().abs().max())
    # one bf16 rounding of fp32 results that agree to 1e-4 of the largest
    check(torch.allclose(got.float(), want.float(), rtol=2 ** -7, atol=1e-4 * omax),
          "real-shape output within one bf16 rounding of the blocked plain version")
    fa_real_err = float((got.float() - want.float()).abs().max())
    print(f"real shape: max abs err {fa_real_err} (max |out| {omax})")
    simt_got = flash_attention.flash_attention_simt(*real)
    torch.cuda.synchronize()
    # the CUDA-core kernel's arithmetic: q·scale and the probabilities in fp32
    simt_want = kref.flash_attention_blocked(*(t.float() for t in real)).bfloat16()
    check(torch.allclose(simt_got.float(), simt_want.float(), rtol=2 ** -7, atol=1e-4 * omax),
          "real-shape CUDA-core output within one bf16 rounding of the fp32 plain version")
    simt_err = float((simt_got.float() - simt_want.float()).abs().max())
    print(f"real shape, CUDA-core kernel: max abs err {simt_err} against the fp32 plain version; "
          f"{float((simt_got.float() - want.float()).abs().max())} from the bf16-P one")
    fa_err_bf16_simt = max(fa_err_bf16_simt, simt_err)
    del simt_got, simt_want
    fa_ms = cuda_ms(lambda: flash_attention.flash_attention_cuda(*real), 20)
    simt_ms = cuda_ms(lambda: flash_attention.flash_attention_simt(*real), 5)
    fa_ms_again = cuda_ms(lambda: flash_attention.flash_attention_cuda(*real), 20)
    fa_plain_ms = cuda_ms(lambda: kref.flash_attention_blocked(*real), 2)
    qt, kt, vt = (t.transpose(1, 2) for t in real)
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                             is_causal=True)
    sdpa_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max())
    fa_lib_ms = cuda_ms(sdpa, 20)
    fa_bound_ms, fa_bound_by, fa_bytes, fa_flops, fa_exps = attn_bound(*real, got)
    print(f"real shape: tensor-core kernel {fa_ms:.4f} ms ({fa_ms_again:.4f} ms again after the "
          f"CUDA-core one), CUDA-core kernel {simt_ms:.4f} ms, plain (blocked) {fa_plain_ms:.4f} ms, "
          f"library call (scaled_dot_product_attention, is_causal) {fa_lib_ms:.4f} ms "
          f"(max abs diff {sdpa_err}); bound {fa_bound_ms:.4f} ms ({fa_bound_by}: "
          f"{fa_flops / 1e9:.1f} GFLOP, {fa_bytes / 1e6:.1f} MB); tensor cores "
          f"{fa_ms / fa_bound_ms:.2f}x bound, CUDA cores {simt_ms / fa_bound_ms:.1f}x bound")
    print(f"exponentials: {fa_exps} ({fa_exps * 1e3 / SFU_OPS_PER_S:.4f} ms at one SFU op each)")
    del real, got, want, x, qt, kt, vt
    torch.cuda.empty_cache()

    # -- 12. the SA-serve study on Zamba2 at full width ---------------------
    phase(f"12 SA-serve study: run_sa_serve on {ZAMBA} at full width")
    out = serve_study(zcfg, zparams, zprompts, cache_bytes=451_399_680,
                      expected={"tasks_total": 108, "planned_tasks_executed": 51,
                                "tasks_executed": 51, "reuse_fraction": 57 / 108,
                                "active_paths": 2, "peak_bytes": 1_015_649_408},
                      launches={"ssm_scan": (ssm_scan.LAUNCHES, zcfg.num_layers * PROMPTS),
                                "flash_attention_wgmma": (flash_attention.WGMMA_LAUNCHES,
                                                          zn_blocks * PROMPTS)},
                      silent={"morph_recon": morph_recon.LAUNCHES,
                              "flash_attention": flash_attention.LAUNCHES}, sa_serve=sa_serve)
    launches["zamba2_serve"] = out["launches"]["ssm_scan"]
    fa_launches = out["launches"]["flash_attention_wgmma"]
    simt_launches = flash_attention.LAUNCHES.value  # checked 0 in the study
    del zparams
    torch.cuda.empty_cache()

    # -- 13. card vs CPU, reduced Zamba2 -------------------------------------
    phase("13 card vs CPU, reduced Zamba2")
    card_vs_cpu(configs.reduced_config(zcfg), sa_serve, init_params, prefill)

    # -- 14. the dataset study ------------------------------------------------
    phase(f"14 dataset study: run_dataset_study over {DATASET_TILES} tiles of {SIZE}x{SIZE}")
    recon_launches = {"run_study": study_launches}
    two_streams(morph_recon, *recon_inputs(pipeline, tile)["seg2"], reps=8)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tiles = [tile] + [mosaic_tile(pipeline, SEED_STEP * t) for t in range(1, DATASET_TILES)]
    dsets = list(sets) + [pipeline.TABLE1_SPACE.default()]
    print(f"tiles: {len(tiles)} mosaics, tile t's sub-tile seeds from {SEED_STEP}·t (tile 0 is "
          f"phase 4's), {time.perf_counter() - t0:.1f} s host; runs: phase 4's {len(sets)} and "
          f"the default set")
    recon_launches["run_dataset_study"], ds14 = dataset_study(
        pipeline, tiles, dsets, study_dice, counters, (task_s, task_n, task_lock, task_streams))
    torch.cuda.empty_cache()

    # -- 15. the adaptive study ----------------------------------------------
    phase(f"15 adaptive study: run_adaptive_study over {ADAPTIVE_TILES} tile of {SIZE}x{SIZE}, "
          f"an obj: store, and its resume")
    print(f"cut: {ADAPTIVE_TILES} of the {DATASET_TILES} tiles (the label loops set the time)")
    recon_launches["run_adaptive_study"] = adaptive_study(
        pipeline, tiles[:ADAPTIVE_TILES], counters, (task_s, task_n, task_lock, task_streams))
    torch.cuda.empty_cache()
    phase("15 card vs CPU at 256x256: the same adaptive study")
    adaptive_card_vs_cpu(pipeline)

    # -- 16. the dataset study on process workers -------------------------------
    phase(f"16 dataset study on process workers: run_dataset_study(backend='process') over "
          f"{DATASET_TILES} tiles of {SIZE}x{SIZE}, two spawn workers")
    recon_launches.update(process_dataset_study(pipeline, tiles, dsets, ds14, counters))
    torch.cuda.empty_cache()

    # -- 17. the one-tile study on socket workers -------------------------------
    phase(f"17 one-tile study on socket workers: run_study(backend='socket') on the {SIZE}x{SIZE} "
          f"tile, two workers over loopback TCP, then one worker SIGKILLed mid-study")
    recon_launches.update(socket_study(pipeline, tile, sets, study_dice, study_wall, counters))
    del tiles, tile
    torch.cuda.empty_cache()

    # -- 18. the fleet ---------------------------------------------------------
    phase(f"18 fleet: run_fleet_study(n_procs=2, size={SIZE}, n_tiles=1, max_rounds=2) against "
          f"one in-process StudyDriver")
    recon_launches.update(fleet_study(pipeline, counters, (task_s, task_n, task_lock, task_streams)))
    torch.cuda.empty_cache()

    # -- 19. the study service -------------------------------------------------
    phase(f"19 service: StudyServer over pathology_service_build(size={SIZE}, n_tiles=1), two "
          f"thread workers, and python -m repro_torch.service serve over TCP")
    recon_launches.update(service_phase(pipeline, sets, counters))
    torch.cuda.empty_cache()

    # -- results -----------------------------------------------------------
    ms_k, ms_p, bound = timing[(f"seg2 {SIZE}x{SIZE}", int(default["RC"]))][:3]
    print(json.dumps({"kernels": [{
        "name": "morph_recon",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/morph_recon.cu",
        "replaces": "src/repro/kernels/morph_recon.py:52",
        "launches": sum(recon_launches.values()),
        "launches_by_path": recon_launches,
        "max_abs_err": max_err,
        "ms": ms_k,
        "plain_ms": ms_p,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
        "fill_holes_ms": timing[(f"fill-holes {SIZE}x{SIZE}", int(default["FH"]))][0],
        "rounds": study_rounds,
        "tile_visits": study_visits,
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:32",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": scan_err,
        "ms": scan_ms,
        "plain_ms": scan_plain_ms,
        "plain_three_pass_ms": scan_3p_ms,
        "bound_ms": scan_bound_ms,
        "bound_by": scan_bound_by,
        "library_ms": None,
        "mamba2_ms": m2_ms,
        "mamba2_plain_ms": m2_plain_ms,
        "mamba2_plain_three_pass_ms": m2_3p_ms,
        "mamba2_bound_ms": m2_bound_ms,
        "mamba2_bound_by": m2_bound_by,
    }, {
        "name": "flash_attention_wgmma",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": fa_launches,
        "max_abs_err": fa_bf16_err,
        "ms": fa_ms,
        "plain_ms": fa_plain_ms,
        "bound_ms": fa_bound_ms,
        "bound_by": fa_bound_by,
        "library_ms": fa_lib_ms,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": simt_launches,
        "max_abs_err": fa_err,
        "max_abs_err_bf16": fa_err_bf16_simt,
        "ms": simt_ms,
        "plain_ms": fa_plain_ms,
        "bound_ms": fa_bound_ms,
        "bound_by": fa_bound_by,
        "library_ms": fa_lib_ms,
        "gemma3_d256": d256,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
