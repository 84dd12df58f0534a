"""The plain references against the port's CPU path at small sizes, through
the drivers themselves: the same weights, inputs and draws, both in fp32."""

import harness
from conftest import small_cell


def test_sample_reference_matches_port():
    cell = small_cell("cinn128_sample_div", dtype="float32")
    harness.setup_torch()
    driver = harness.make_driver(cell, 2**31 + 17, "cpu")
    driver.setup()
    driver.unit(0)
    checks = dict((n, v) for n, v, _ in driver.check())
    assert checks["frames_mae"] < 1e-5 and checks["worst_clip_mae"] < 1e-5, checks


def test_first_stage_reference_matches_port():
    cell = small_cell("fs64_train")
    harness.setup_torch()
    driver = harness.make_driver(cell, 2**31 + 18, "cpu")
    driver.setup()
    driver.check()
    n = driver.numbers
    assert n["loss0_d_rel"] < 1e-5 and n["grad1_gap.disc"] < 1e-4, n
    assert n["grad1_med_gap.model"] < 1e-4 and n["change3_gap"] < 0.1, n
