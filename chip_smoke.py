#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit, TF32 off;
2. build: the ``morph_recon`` CUDA kernel from the checkout's source;
3. kernel vs its plain PyTorch version on the card, ``torch.equal``, on
   random cases and on the real Seg2 and fill-holes inputs of the 4096²
   tile, with the kernel's time, launches, bound and the plain time;
4. the single-tile SA study, ``repro_torch.app.run_study``, on a 4096²
   tile with the 16-run MOAT design over Table I, counting kernel launches;
5. the same study code on card and CPU at 256², Dice within 1e-3.

The last three lines are the kernels JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke.py: check failed: {what}")


def recon_bound_ms(numel: int, conn: int) -> float:
    """Least time for one reconstruction on this card: marker and mask read
    once and the result written once (12 bytes a pixel) over the memory
    rate, or one max per neighbour and one min per pixel over the fp32
    rate, whichever is larger (always the bytes here)."""
    return max(12 * numel / HBM_BYTES_PER_S, (conn + 1) * numel / FP32_OPS_PER_S) * 1e3


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
    from repro_torch.app import pipeline
    from repro_torch.core import halton_sequence, morris_trajectories
    from repro_torch.kernels import morph_recon

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

    # -- 2. build ---------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    build = morph_recon.build()
    print(f"morph_recon: nvcc {' '.join(morph_recon.NVCC_FLAGS)}")
    print(f"build seconds: {build.seconds if build.seconds is not None else 'cached'} "
          f"(load total {time.perf_counter() - t0:.3f})")
    for ln in build.ptxas_info.splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            print(ln.strip())

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
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
