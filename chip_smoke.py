#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit, TF32 off; both kernels start
   building (one ``nvcc`` each, in parallel);
2. build: the ``morph_recon`` CUDA kernel from the checkout's source;
3. kernel vs its plain PyTorch version on the card, ``torch.equal``, on
   random cases and on the real Seg2 and fill-holes inputs of the 4096²
   tile, with the kernel's time, launches, bound and the plain time;
4. the single-tile SA study, ``repro_torch.app.run_study``, on a 4096²
   tile with the 16-run MOAT design over Table I, counting kernel launches;
5. the same study code on card and CPU at 256², Dice within 1e-3;
6. build: the ``ssm_scan`` CUDA kernel;
7. ``ssm_scan`` vs its two plain versions on the card in fp32, on the cases
   of tests/test_kernel_ssm_scan.py, then at the prefill's real shape and
   types (layer 0 of RWKV-6 1.6B), with the kernel's time, bound and the
   plain time;
8. the SA-serve study, ``repro_torch.core.sa_serve.run_sa_serve``, on RWKV-6
   1.6B at full width: 3 prompts of 1024 tokens × 12 decoding settings ×
   3 thresholds, counting kernel launches;
9. the same serve study code on card and CPU on the reduced RWKV-6.

The last three lines are the kernels JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import itertools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, same sheet
SIZE = 4096
SUB = 512  # the tile is an 8×8 mosaic of SUB² synthetic tiles
MOAT_RUNS = 16  # the whole 15-parameter trajectory: 16 runs
ARCH = "rwkv6_1p6b"
PROMPTS, PROMPT_LEN, GEN_LEN = 3, 1024, 16
PENALTIES, TOP_KS = (1.0, 1.3), (4, 16)
# (B, S, H, N, P, chunk) and (S, chunk, per_channel, seed): the cases of
# tests/test_kernel_ssm_scan.py and tests/test_torch_ssm_scan.py
SCAN_SHAPES = [(1, 16, 1, 4, 4, 8), (2, 32, 2, 8, 16, 8), (1, 33, 1, 8, 8, 16),
               (1, 64, 3, 16, 32, 64)]
SCAN_SWEEP = [(4, 4, False, 0), (17, 8, True, 11), (33, 32, False, 5), (50, 16, True, 123),
              (64, 4, True, 7), (70, 32, True, 999), (9, 16, False, 42)]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke.py: check failed: {what}")


def recon_bound_ms(numel: int, conn: int) -> float:
    """Least time for one reconstruction on this card: marker and mask read
    once and the result written once (12 bytes a pixel) over the memory
    rate, or one max per neighbour and one min per pixel over the fp32
    rate, whichever is larger (always the bytes here)."""
    return max(12 * numel / HBM_BYTES_PER_S, (conn + 1) * numel / FP32_OPS_PER_S) * 1e3


def scan_bound(x, a, b, c, y, hf):
    """Least time for one scan on this card, and what bounds it: each input
    read once and each output written once over the memory rate, against
    the recurrence's 5·N·P flops a token and head (decay, input and
    readout products and sums) over the fp32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, a, b, c, y, hf))
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


def serve_grid(n_prompts, thresholds):
    return [
        tuple(sorted({"prompt_id": p, "rep_penalty": rp, "top_k": k, "threshold": th}.items()))
        for p, rp, k, th in itertools.product(range(n_prompts), PENALTIES, TOP_KS, thresholds)
    ]


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


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


def mosaic_tile(pipeline) -> np.ndarray:
    """SIZE² tile as a mosaic of SUB² synthetic tiles with seeds 0, 1, ...
    in row-major order (one SIZE² synthetic tile costs about an hour of
    host time; the generator's cost grows with the square of the area)."""
    n = SIZE // SUB
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        subs = list(pool.map(lambda s: pipeline.synthetic_tile(SUB, SUB, seed=s), range(n * n)))
    rows = [np.concatenate(subs[r * n : (r + 1) * n], axis=1) for r in range(n)]
    return np.concatenate(rows, axis=0)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.app import pipeline
    from repro_torch.core import halton_sequence, morris_trajectories, sa_serve
    from repro_torch.kernels import morph_recon, nvcc, ssm_scan
    from repro_torch.kernels import ref as kref
    from repro_torch.models import init_params, prefill
    from repro_torch.models import ssm as ssm_mod
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
    build_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    builds = {"morph_recon": build_pool.submit(morph_recon.build),
              "ssm_scan": build_pool.submit(ssm_scan.build)}
    build_pool.shutdown(wait=False)

    def show_build(name):
        build = builds[name].result()
        print(f"{name}: nvcc {' '.join(nvcc.NVCC_FLAGS)}")
        print(f"build seconds: {build.seconds if build.seconds is not None else 'cached'} "
              f"(both builds started {time.perf_counter() - t_build:.3f} s ago)")
        for ln in build.ptxas_info.splitlines():
            if "registers" in ln or "Compiling entry" in ln or "smem" in ln:
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
    del st, residual

    cases = {f"random {h}x{w}": random_case(h, w, seed=h + w) for h, w in
             [(65, 33), (1, 1), (31, 1000), (SIZE, SIZE)]}
    cases[f"seg2 {SIZE}x{SIZE}"] = (seg2_marker, gray)
    cases[f"fill-holes {SIZE}x{SIZE}"] = (border, inv)
    max_err = 0.0
    timing = {}
    for name, (mk, ms) in cases.items():
        for conn in (4, 8):
            before = morph_recon.LAUNCHES.value
            got = morph_recon.morph_reconstruct_cuda(mk, ms, conn=conn)
            torch.cuda.synchronize()
            launches = morph_recon.LAUNCHES.value - before
            want = morph_recon.morph_reconstruct_ref(mk, ms, conn=conn)
            check(torch.equal(got, want), f"morph_recon == plain on {name} conn={conn} "
                  f"({int((got != want).sum())} pixels differ)")
            max_err = max(max_err, float((got - want).abs().max()))
            line = f"{name} conn={conn}: equal, {launches} launches"
            if mk.numel() == SIZE * SIZE:
                ms_k = cuda_ms(lambda: morph_recon.morph_reconstruct_cuda(mk, ms, conn=conn), 5)
                ms_p = cuda_ms(lambda: morph_recon.morph_reconstruct_ref(mk, ms, conn=conn), 2)
                bound = recon_bound_ms(mk.numel(), conn)
                timing[(name, conn)] = (ms_k, ms_p, bound, launches)
                line += f"; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound {bound:.4f} ms (bytes)"
            print(line, flush=True)
    print("kernels: morph_recon")
    print(f"max_abs_err {max_err}")
    print("library call: none (no one PyTorch call computes reconstruction by dilation; "
          "max_pool2d is one dilation step)")
    del cases, seg2_marker, gray, border, inv
    torch.cuda.empty_cache()

    # -- 4. the study ------------------------------------------------------
    phase(f"4 study: run_study on the {SIZE}x{SIZE} tile, MOAT over Table I")
    sets, _ = morris_trajectories(pipeline.TABLE1_SPACE, 1, seed=0)
    sets = sets[:MOAT_RUNS]
    print(f"runs: {len(sets)} of {len(sets)} (MOAT trajectory, seed 0)")
    task_s = collections.Counter()
    task_n = collections.Counter()

    def timed(name, fn):
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

    for name in ("_t_normalize", "_t_background", "_t_rbc", "_t_recon",
                 "_t_threshold", "_t_area_pre", "_t_watershed", "_t_area_final"):
        setattr(pipeline, name, timed(name[3:], getattr(pipeline, name)))

    torch.cuda.reset_peak_memory_stats()
    morph_recon.LAUNCHES.reset()
    t0 = time.perf_counter()
    out = pipeline.run_study(tile, sets, strategy="rmsr")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    study_launches = morph_recon.LAUNCHES.value
    check(out["tasks_total"] == 8 * len(sets) == 128, f"tasks_total {out['tasks_total']} == 128")
    check(out["planned_tasks_executed"] == 71,
          f"planned tasks_executed {out['planned_tasks_executed']} == 71")
    check(all(0.0 <= d <= 1.0 for d in out["dice"]), f"dice in [0, 1]: {out['dice']}")
    check(study_launches > 0, "the study launched morph_recon")
    print(f"wall {wall:.3f} s; tasks_total {out['tasks_total']}; planned tasks_executed "
          f"{out['planned_tasks_executed']}; measured tasks_executed {out['tasks_executed']}; "
          f"cache_hits {out['cache_hits']}; reuse_fraction {out['reuse_fraction']}")
    print(f"morph_recon launches in the study: {study_launches}")
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print("dice " + " ".join(f"{d:.6f}" for d in out["dice"]))
    print("per-task seconds (tasks of the study and its reference run; each timed between syncs):")
    for name in task_s:
        print(f"  {name}: {task_n[name]} tasks, {task_s[name]:.3f} s")
    ref = pipeline.run_study(tile, [pipeline.TABLE1_SPACE.default()])
    check(ref["dice"] == [1.0], f"default-parameter dice {ref['dice']} == [1.0]")
    print("default-parameter study: dice [1.0]")
    del tile
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
                                ("chunked", kref.ssm_scan_chunked(x, a, b, c, chunk=chunk))):
            check(torch.allclose(y, yp, rtol=tol, atol=tol) and torch.allclose(hf, hp, rtol=tol, atol=tol),
                  f"ssm_scan within {tol} of ssm_scan_{plain} on {name}")
            errs.append(max(float((y - yp).abs().max()), float((hf - hp).abs().max())))
        scan_err = max(scan_err, *errs)
        print(f"{name} chunk={chunk}: max abs err vs ref {errs[0]:.3g}, vs chunked {errs[1]:.3g}")
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
    y, hf = ssm_scan.ssm_scan_cuda(*real)
    torch.cuda.synchronize()
    yp, hp = kref.ssm_scan_chunked(*real)
    ymax, hmax = float(yp.float().abs().max()), float(hp.abs().max())
    # y: one bf16 rounding of fp32 sums that agree to 1e-4 of the largest y;
    # h_final: fp32, the kernel's bar relative to the largest state value
    check(torch.allclose(y.float(), yp.float(), rtol=2 ** -7, atol=1e-4 * ymax),
          "real-shape y within one bf16 rounding of the plain version")
    check(torch.allclose(hf, hp, rtol=2e-4, atol=2e-4 * max(1.0, hmax)),
          "real-shape h_final within 2e-4 of the plain version")
    real_err = (float((y.float() - yp.float()).abs().max()), float((hf - hp).abs().max()))
    print(f"real shape: y max abs err {real_err[0]} (max |y| {ymax}); "
          f"h_final max abs err {real_err[1]} (max |h| {hmax})")
    scan_ms = cuda_ms(lambda: ssm_scan.ssm_scan_cuda(*real), 50)
    scan_plain_ms = cuda_ms(lambda: kref.ssm_scan_chunked(*real), 5)
    scan_bound_ms, scan_bound_by = scan_bound(*real, y, hf)
    print(f"real shape: kernel {scan_ms:.4f} ms, plain (chunked) {scan_plain_ms:.4f} ms, "
          f"bound {scan_bound_ms:.4f} ms ({scan_bound_by}); {scan_ms / scan_bound_ms:.1f}x bound")
    print("library call: none (no one PyTorch call computes a gated linear recurrence)")
    del cases, real, y, hf, yp, hp, r, k, v, w, xe, xa
    torch.cuda.empty_cache()

    # -- 8. the SA-serve study at full width -------------------------------
    phase(f"8 SA-serve study: run_sa_serve on {ARCH} at full width")
    max_len = PROMPT_LEN + GEN_LEN
    pilot = sa_serve.build_serve_stage(cfg, params, prompts, gen_len=GEN_LEN, max_len=max_len)
    cache_b = pilot.tasks[0].output_bytes
    check(cache_b == 12_779_520, f"cache bytes {cache_b} == 12,779,520")
    # thresholds inside the confidences this model produces: quartiles of a
    # pilot generation (at random init a token's confidence is near 1/vocab)
    pstate = pilot.tasks[0].fn({}, prompt_id=0)
    conf = torch.cat([pilot.tasks[1].fn(pstate, rep_penalty=rp, top_k=TOP_KS[0])["conf"].ravel()
                      for rp in PENALTIES]).cpu().numpy()
    thresholds = [float(q) for q in np.quantile(conf, [0.25, 0.5, 0.75])]
    print(f"pilot confidences: min {conf.min():.6g}, max {conf.max():.6g}; "
          f"thresholds {[f'{t:.6g}' for t in thresholds]}")
    del pstate
    sets = serve_grid(PROMPTS, thresholds)
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
    ssm_scan.LAUNCHES.reset()
    morph_recon.LAUNCHES.reset()
    t0 = time.perf_counter()
    out = sa_serve.run_sa_serve(cfg, params, prompts, sets, gen_len=GEN_LEN, max_len=max_len,
                                hbm_budget_bytes=budget, policy="rmsr")
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = ssm_scan.LAUNCHES.value
    sa_serve.build_serve_stage = build_stage
    print(f"sets {len(sets)} (3 prompts x rep_penalty {PENALTIES} x top_k {TOP_KS} x 3 thresholds); "
          f"hbm_budget_bytes {budget}")
    print(f"wall {serve_wall:.3f} s; tasks_total {out['tasks_total']}; planned tasks_executed "
          f"{out['planned_tasks_executed']}; measured tasks_executed {out['tasks_executed']}; "
          f"reuse_fraction {out['reuse_fraction']}; active_paths {out['active_paths']}; "
          f"peak_bytes {out['peak_bytes']}; cache_hits {out['cache_hits']}")
    expected = {"tasks_total": 108, "planned_tasks_executed": 51, "tasks_executed": 51,
                "reuse_fraction": 57 / 108, "active_paths": 2, "peak_bytes": 28_754_048}
    for key, want in expected.items():
        check(out[key] == want, f"{key} {out[key]} == {want} (the JAX planner's count)")
    check(serve_launches == cfg.num_layers * PROMPTS,
          f"ssm_scan launches {serve_launches} == {cfg.num_layers} x {PROMPTS}")
    check(morph_recon.LAUNCHES.value == 0, "no morph_recon launch in the serve study")
    rates = out["accept_rate"]
    check(len(rates) == len(sets) and all(0.0 <= r <= 1.0 for r in rates.values()),
          "an accept rate in [0, 1] for every set")
    check(len(set(rates.values())) > 1, "accept rates differ across the grid")
    gen_tokens = task_n["generate"] * GEN_LEN
    print(f"ssm_scan launches in the study: {serve_launches}")
    print(f"generated tokens {gen_tokens}: {gen_tokens / task_s['generate']:.3f} tokens/s over "
          f"the generate tasks, {gen_tokens / serve_wall:.3f} tokens/s over the wall")
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
    del state, pilot, params
    torch.cuda.empty_cache()

    # -- 9. card vs CPU, reduced RWKV-6 -----------------------------------
    phase("9 card vs CPU, reduced RWKV-6")
    rcfg = configs.reduced_config(cfg)
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
    state_rel = float((cc["state"].cpu() - cp["state"]).norm() / cp["state"].norm())
    # bf16: cuBLAS and the CPU round some products to the other neighbour,
    # and random weights amplify that over the layers (as between the port
    # and the JAX package on the CPU, tests/test_torch_models.py)
    check(logit_err <= 0.05, f"prefill logits card vs CPU: max abs diff {logit_err} <= 0.05")
    check(state_rel <= 0.03, f"h_final card vs CPU: relative difference {state_rel} <= 0.03")
    differ = sum(card["accept_rate"][i] != cpu["accept_rate"][i] for i in range(len(rsets)))
    print(f"tasks equal ({card['tasks_total']}/{card['tasks_executed']}); prefill logits max abs "
          f"diff {logit_err}; h_final relative diff {state_rel}; accept rates differ in "
          f"{differ} of {len(rsets)} sets")

    # -- results -----------------------------------------------------------
    ms_k, ms_p, bound, _ = timing[(f"seg2 {SIZE}x{SIZE}", int(default["RC"]))]
    print(json.dumps({"kernels": [{
        "name": "morph_recon",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/morph_recon.cu",
        "replaces": "src/repro/kernels/morph_recon.py:52",
        "launches": study_launches,
        "max_abs_err": max_err,
        "ms": ms_k,
        "plain_ms": ms_p,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:32",
        "launches": serve_launches,
        "max_abs_err": scan_err,
        "ms": scan_ms,
        "plain_ms": scan_plain_ms,
        "bound_ms": scan_bound_ms,
        "bound_by": scan_bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
