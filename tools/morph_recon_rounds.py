"""Where a ``morph_recon`` call spends its time on the card: each round's
tiles and SM clock cycles, and a visit's cycles in its phases.

Builds a copy of ``src/repro_torch/kernels/csrc/morph_recon.cu`` with
``clock64()`` probes at fixed lines (the script stops if a line it probes is
gone), into the kernels' git-ignored ``_build/``, and runs it through the
port's wrapper on the 4096² inputs of ``chip_smoke.py`` phase 3: the Seg2
and fill-holes reconstructions of the default-parameter run (conn 4 and 8)
and the random case. For each it prints the time a call by CUDA events
(the probes' atomics included), the rounds and tile visits, every round's
tiles and cycles (block 0's clock between round starts), and per visit the
cycles of the copy-in, the passes and the write-back, the passes and the
rows a visit runs, the cycles a row, and the share of the blocks' time
spent waiting at the grid barrier.

    python3 tools/morph_recon_rounds.py    # needs a CUDA card
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import SIZE, mosaic_tile, random_case, recon_inputs  # noqa: E402
from repro_torch.app import pipeline  # noqa: E402
from repro_torch.kernels import morph_recon, nvcc  # noqa: E402

MAX_ROUNDS = 256  # rounds the timeline keeps
# (line of the source, what to put before it): the probes
PROBES = [
    ("namespace {\n",
     "__device__ unsigned long long g_phase[8];  // load, passes, store, passes run, visits,"
     " barrier wait, rows run\n"
     f"__device__ long long g_round[{MAX_ROUNDS + 2}];\n"
     f"__device__ int g_tiles[{MAX_ROUNDS + 2}];\n"),
    ("  float cmk[4];      // ... of the corners\n", "  unsigned rows_run;\n"),
    ("  // what changed in the halo since the tile's last visit; lane 0 fetches\n",
     "  const long long c0 = clock64();\n"),
    ("  // the border at the visit's start, to tell the neighbours what changed\n",
     "  const long long c1 = clock64();\n  if (lane == 0) S.rows_run = 0;\n"),
    ("      const float old[K] = {v4.x, v4.y, v4.z, v4.w};\n", "      if (lane == 0) ++S.rows_run;\n"),
    ("  for (int r = 0; r < TH && y0 + r < p.h; ++r)\n    if (first || ((touched >> r) & 1u))\n",
     "  const long long c2 = clock64();\n"),
    ("  if (!touched) return;  // nothing moved and the tile is settled\n",
     "  if (lane == 0) {\n"
     "    atomicAdd(&g_phase[0], (unsigned long long)(c1 - c0));\n"
     "    atomicAdd(&g_phase[1], (unsigned long long)(c2 - c1));\n"
     "    atomicAdd(&g_phase[2], (unsigned long long)(clock64() - c2));\n"
     "    atomicAdd(&g_phase[4], 1ull);\n"
     "    atomicAdd(&g_phase[6], (unsigned long long)S.rows_run);\n"
     "  }\n"),
    ("    grid.sync();\n", "    const long long b0 = clock64();\n"),
    ("  if (blockIdx.x == 0 && threadIdx.x == 0) {\n    atomicAdd(&p.totals[0]",
     f"  if (blockIdx.x == 0 && threadIdx.x == 0 && k <= {MAX_ROUNDS}) {{\n"
     "    g_round[k] = clock64();\n    g_tiles[k] = 0;\n  }\n"),
]
# (line, what to put after it)
AFTER = [
    ("    visits += count;\n",
     f"    if (blockIdx.x == 0 && threadIdx.x == 0 && k <= {MAX_ROUNDS}) {{\n"
     "      g_round[k] = clock64();\n      g_tiles[k] = count;\n    }\n"),
    ("    grid.sync();\n",
     "    if (threadIdx.x == 0) atomicAdd(&g_phase[5], (unsigned long long)(clock64() - b0));\n"),
    ("      rows = pass<CONN, true>(S, lane, dirty_fwd);\n",
     "      if (lane == 0) atomicAdd(&g_phase[3], 1ull);\n"),
    ("      rows = pass<CONN, false>(S, lane, dirty_bwd);\n",
     "      if (lane == 0) atomicAdd(&g_phase[3], 1ull);\n"),
]
READERS = f"""
extern "C" int morph_recon_probes(unsigned long long* phase, long long* rounds, int* tiles) {{
  cudaMemcpyFromSymbol(phase, g_phase, sizeof(g_phase));
  cudaMemcpyFromSymbol(rounds, g_round, sizeof(g_round));
  return (int)cudaMemcpyFromSymbol(tiles, g_tiles, sizeof(g_tiles));
}}

extern "C" int morph_recon_probes_reset() {{
  unsigned long long z[8] = {{0}};
  long long r[{MAX_ROUNDS + 2}] = {{0}};
  int t[{MAX_ROUNDS + 2}] = {{0}};
  cudaMemcpyToSymbol(g_round, r, sizeof(r));
  cudaMemcpyToSymbol(g_tiles, t, sizeof(t));
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}}
"""


def probed_source() -> str:
    src = nvcc.source("morph_recon").read_text()
    for line, text in PROBES:
        if src.count(line) != 1:
            raise SystemExit(f"morph_recon_rounds.py: the line to probe is gone: {line!r}")
        src = src.replace(line, text + line)
    for line, text in AFTER:
        if src.count(line) != 1:
            raise SystemExit(f"morph_recon_rounds.py: the line to probe is gone: {line!r}")
        src = src.replace(line, line + text)
    return src + READERS


def build_probed() -> nvcc.Build:
    # the kernels' own build directory and nvcc (git-ignored, beside csrc/)
    out_dir = nvcc._BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "morph_recon_probed.cu"
    src.write_text(probed_source())
    lib = out_dir / "libmorph_recon_probed.so"
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}")
    return nvcc.Build(ctypes.CDLL(str(lib)), None, "")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    probed = build_probed()
    lib = probed.lib
    lib.morph_recon.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.morph_recon.restype = ctypes.c_int
    lib.morph_recon_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.morph_recon_scratch_ints.argtypes = [ctypes.c_int] * 2
    lib.morph_recon_scratch_ints.restype = ctypes.c_longlong
    lib.morph_recon_max_blocks.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    morph_recon.build = lambda: probed  # the wrapper, unchanged, on the probed build

    cases = dict(recon_inputs(pipeline, mosaic_tile(pipeline)))
    cases["random"] = random_case(SIZE, SIZE, seed=2 * SIZE)
    phase = (ctypes.c_ulonglong * 8)()
    rounds_at = (ctypes.c_longlong * (MAX_ROUNDS + 2))()
    tiles_at = (ctypes.c_int * (MAX_ROUNDS + 2))()
    for name, (mk, ms) in cases.items():
        for conn in (4, 8):
            blocks = morph_recon.max_blocks(conn)[0]
            morph_recon.morph_reconstruct_cuda(mk, ms, conn)  # warm-up
            torch.cuda.synchronize()
            lib.morph_recon_probes_reset()
            before = (morph_recon.ROUNDS.value, morph_recon.TILE_VISITS.value)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            morph_recon.morph_reconstruct_cuda(mk, ms, conn)
            end.record()
            torch.cuda.synchronize()
            rounds = morph_recon.ROUNDS.value - before[0]
            visits = morph_recon.TILE_VISITS.value - before[1]
            lib.morph_recon_probes(phase, rounds_at, tiles_at)
            v = max(phase[4], 1)
            total = rounds_at[min(rounds, MAX_ROUNDS) + 1] - rounds_at[1]
            per_round = " ".join(
                f"{k}:{tiles_at[k]}:{rounds_at[k + 1] - rounds_at[k]}"
                for k in range(1, min(rounds, MAX_ROUNDS) + 1))
            print(f"{name} {SIZE}x{SIZE} conn {conn}: {start.elapsed_time(end):.4f} ms with the "
                  f"probes; {rounds} rounds, {visits} tile visits; kernel {total} cycles (block 0)")
            print(f"  rounds (round:tiles:cycles) {per_round}")
            print(f"  a visit: copy-in {phase[0] / v:.0f}, passes {phase[1] / v:.0f}, write-back "
                  f"{phase[2] / v:.0f} cycles; {phase[3] / v:.2f} passes, {phase[6] / v:.1f} rows "
                  f"run, {phase[1] / max(phase[6], 1):.0f} cycles a row; the blocks waited at the "
                  f"grid barrier {phase[5] / (blocks * max(total, 1)):.3f} of their time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
