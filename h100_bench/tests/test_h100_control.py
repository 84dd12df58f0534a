"""The controls come out not correct: each cell's reference, computed in
the next precision below the configuration's (fp8 under a bf16 pass, TF32
under an fp32 step), in the program's place at the cell's own size, on
three seeds, fails at least one of the cell's limits on every seed (a
control that gives no number has failed too).  On the card only:

    python -m pytest -m cuda h100_bench/tests/test_h100_control.py
"""

import math

import pytest

import harness
import readings


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cinn128_sample_div", "fs64_train"])
def test_control_fails_the_limits(workload, card):
    harness.setup_torch()
    cell = harness.find_cell(workload)
    limits = cell.config["limits"]
    for row in readings.read(cell, [2**31 + 101, 2**31 + 102, 2**31 + 103], True, card):
        assert row["failed"] or any(not math.isfinite(v) or v > limits[k]
                                    for k, v in row["checks"].items()), row
