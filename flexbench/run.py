"""Run one cell of the benchmark once.

    python3 flexbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints one JSON line on standard output;
exits with another code than 0, printing no result, where no CUDA device
is visible.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# Compiled bytecode of every module the run imports goes to a fixed folder
# of the checkout, also where the environment turns writing it off, so
# that only a checkout's first run compiles those sources.
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False

from flexbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
