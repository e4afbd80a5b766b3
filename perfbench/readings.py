"""Readings from which a cell's limits are set: for each seed, the numbers
that a run compares, from a short window of ``--items`` items at the
cell's own load, and with ``--control`` the same numbers of the control
(the reference in the precision below the configuration's). Needs the
card; one process for every seed:

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 [--control] [--items 1]

prints one JSON line a seed.
"""

import argparse
import json
import pathlib
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def readings(workload: str, seed: int, items: int, control: bool, device=None):
    cell, config, mod = harness.find_cell(harness.ROOT, workload)
    driver = mod.Driver(config, cell, seed, device or torch.device("cuda", 0))
    driver.setup()
    t0 = time.perf_counter()
    with driver.patch(None):
        for item in range(items):
            driver.run_item(item)
    window = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out = driver.check(control=control)
    return {"seed": seed, "window_s": window, "check_s": time.perf_counter() - t1, **out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--items", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.items, args.control)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
