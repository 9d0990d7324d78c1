#!/usr/bin/env python3
"""One run of one cell of the port's benchmark on this machine's card:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the run's notes and, as its last lines, each number the check
compared beside its limit on standard error, and the result as one JSON
line on standard output.  Exits 3, printing no result, where the cell's
cards are missing.  See ``bench/README.md``."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
