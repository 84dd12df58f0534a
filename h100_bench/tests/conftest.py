"""Shared pieces of the benchmark's tests: the harness on ``sys.path``,
the cells cut to CPU sizes (the configurations' widths cut, their limits
and drivers kept), and the card's fixture."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402

# SMALL's widths (ipoke_tpu_torch/entry.py) cut in depth and frames
SAMPLE_SMALL = dict(spatial=64, min_spatial=8, T=3, z_dim=32, dec_ch=[128, 128, 64, 32],
                    n_gru_layers=2, nf_cond=32, num_steps=[1, 1], mid_factor=8, factor=16,
                    flow_perturb={"shift": 0.1, "scale": 0.01})
# FIRST_STAGE_TINY (the JAX package's first-stage test config)
FIRST_STAGE_TINY = {
    "data": {"spatial_size": [32, 32], "max_frames": 3, "batch_size": 2},
    "architecture": {"z_dim": 8, "ENC_M_channels": [16, 16, 32, 32],
                     "dec_channels": [32, 32, 16, 16], "n_gru_layers": 2,
                     "min_spatial_size": 4, "norm": "group", "spectral_norm": True,
                     "motion_bias": True},
    "training": {"lr": 1e-3, "weight_decay": 1e-5, "w_kl": 1e-6, "w_l1": 10.0,
                 "w_vgg": 1.0, "full_sequence": True},
    "d_t": {"use": True, "pretrain": 0, "max_frames": 3, "gp_weight": 1.0,
            "gen_weight": 1.0, "fmap_weight": 1.0, "layers": [1, 1, 1, 1]},
    "d_s": {"use": True, "pretrain": 0, "n_examples": 4, "ndf": 16, "n_layers": 2},
}


def bench() -> dict:
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def small_cell(workload: str, **config) -> harness.Cell:
    """The workload's cell at a CPU size: its files, with the sizes cut."""
    cell = harness.find_cell(workload)
    if cell.traffic["driver"] == "sample_pass":
        cell.config = dict(cell.config, model=SAMPLE_SMALL, flow_params_m=2.78, **config)
        cell.traffic = dict(cell.traffic, clips=2, draws_per_clip=2, reference_block=4)
    else:
        cell.config = dict(cell.config, model=FIRST_STAGE_TINY, **config)
        cell.traffic = dict(cell.traffic, batch=2)
    return cell


def run_small(cell, capsys, seconds="1", trace="0"):
    """One run of ``cell`` on the CPU: (return code, result line)."""
    import time

    harness.setup_torch().set_num_threads(1)
    rc = harness.run(["--workload", cell.name, "--seed", "2147483999", "--seconds", seconds,
                      "--trace", trace], time.perf_counter(), cell=cell, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if rc == 0 else None


@pytest.fixture
def card():
    """The CUDA device, or a skip: the control runs only on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
