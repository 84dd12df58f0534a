"""The readings that a cell's limits are set from, outside the benchmark's
own runs: for each seed, a short run at the cell's own sizes (the
traffic's ``checked_passes`` units, each kept and compared), and the
numbers compared with the plain reference.  With ``--control`` the
reference in the configuration's lower precision (``control`` in its
file) takes the program's place; the limits must fail it.

    python3 h100_bench/readings.py --workload <name> --seeds 1,2,3 [--control]

One process reads every seed, so the kernels build and compile once.
Prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402


def read(cell, seeds, control, device):
    """[{seed, checks: {name: value}}] for ``seeds``."""
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        driver = harness.make_driver(cell, seed, device, cell.config["control"] if control else None)
        driver.setup()
        for i in range(driver.units_to_check()):
            driver.unit(i)
        checks = driver.check()
        row = {"seed": seed, "control": control, "failed": driver.failed,
               "seconds": time.perf_counter() - t0,
               "checks": {name: value for name, value, _ in checks}}
        if hasattr(driver, "numbers"):
            row["numbers"] = driver.numbers
        print(json.dumps(row), flush=True)
        out.append(row)
        del driver
    return out


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    torch = harness.setup_torch()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    read(harness.find_cell(args.workload), [int(s) for s in args.seeds.split(",")],
         args.control, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
