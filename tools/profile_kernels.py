"""Device time of each CUDA kernel behind the port's wrappers, by
``torch.profiler``, at the prefill shapes of ``chip_smoke.py``:

- ``ssm_scan`` at Mamba2's shape (1, 4096, 80, 64), bf16 x/b/c with c one
  row broadcast over the heads (stride 0) and a per-head fp32 decay, as
  Zamba2 2.7B passes them; its three passes (state, carry, output) apart;
- ``ssm_scan`` at RWKV-6's shape (1, 1024, 32, 64), bf16, per-channel
  decay;
- attention at (1, 4096, 32, 80) bf16, causal (the tensor-core kernel);
- ``morph_recon`` at 4096², conn 4 and 8, on ``chip_smoke.py``'s random
  case of phase 3 (``random_case(4096, 4096, seed=8192)``).

Inputs are random, drawn from a seed (on the card, or with numpy for
``morph_recon``). Each wrapper is called once to build and warm up, then
``REPS`` times back to back timed by CUDA events, then ``REPS`` times under
the profiler; the script prints the wrapper's time a call by CUDA events
(without and with the profiler) and each kernel's mean device time a call,
so the difference is what the host adds between calls.

    python3 tools/profile_kernels.py    # needs a CUDA card
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import random_case  # noqa: E402
from repro_torch.kernels import flash_attention, morph_recon, ssm_scan  # noqa: E402

REPS = 20


def profile(name: str, fn) -> None:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    print(f"{name}: {start.elapsed_time(end) / REPS:.4f} ms a call (CUDA events, profiler off)")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
    print(f"{name}: {start.elapsed_time(end) / REPS:.4f} ms a call (CUDA events, profiler on)")
    for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
        if e.device_time_total > 0:
            print(f"  {e.device_time_total / REPS / 1e3:.4f} ms a call, {e.count // REPS} a call: "
                  f"{e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def decay(*shape):
        return torch.exp(-torch.exp(normal(*shape, std=0.7) - 1.0))

    b, s, h, n, p = 1, 4096, 80, 64, 64
    x, bb = normal(b, s, h, p).bfloat16(), normal(b, s, h, n, std=0.5).bfloat16()
    c = normal(b, s, 1, n, std=0.5).bfloat16().expand(b, s, h, n)
    a = decay(b, s, h)
    profile(f"ssm_scan, Mamba2 {(b, s, h, n, p)} per head",
            lambda: ssm_scan.ssm_scan_cuda(x, a, bb, c))

    b, s, h, n, p = 1, 1024, 32, 64, 64
    x, bb, c = (normal(b, s, h, d, std=sd).bfloat16() for d, sd in ((p, 1.0), (n, 0.5), (n, 0.5)))
    a = decay(b, s, h, n)
    profile(f"ssm_scan, RWKV-6 {(b, s, h, n, p)} per channel",
            lambda: ssm_scan.ssm_scan_cuda(x, a, bb, c))

    q, k, v = (normal(1, 4096, 32, 80).bfloat16() for _ in range(3))
    profile("attention (1, 4096, 32, 80) bf16 causal",
            lambda: flash_attention.flash_attention_cuda(q, k, v))
    del q, k, v

    mk, ms = random_case(4096, 4096, seed=8192)
    for conn in (4, 8):
        profile(f"morph_recon 4096x4096 random case, conn {conn}",
                lambda: morph_recon.morph_reconstruct_cuda(mk, ms, conn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
