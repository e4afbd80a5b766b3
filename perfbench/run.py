"""Run one benchmark cell once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared with the plain reference, each beside
its limit, are the last lines of standard error. Exits non-zero, printing
no result, without a CUDA card.
"""

import time

STARTED = time.time()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(started=STARTED))
