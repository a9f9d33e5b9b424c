#!/usr/bin/env python3
"""Benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``.  The last line of
standard output is the run's JSON result; the numbers compared for
``correct`` end standard error.  Exits non-zero, with no result, where no
CUDA device is present or the cell cannot run.
"""
import time

T_START = time.perf_counter()

import sys                                    # noqa: E402
from pathlib import Path                      # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main            # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
