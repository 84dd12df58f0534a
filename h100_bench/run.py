"""Run one cell of the port's benchmark once on this machine's CUDA device:

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of stdout is the result (JSON);
the numbers compared with the plain reference, each beside its limit, are
the last lines of stderr.  Without enough CUDA devices it prints no result
and exits with 2.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(sys.argv[1:], T_START))
