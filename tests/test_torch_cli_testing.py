"""The port's ``--test`` modes through its CLI on the CPU (``python -m
ipoke_tpu_torch.main ... --device cpu --test <mode> --debug``), port only,
at toy size: the conv pipeline of ``tests/test_torch_cli.py`` up to the
second stage (one epoch of 2 batches each), then each of the seven modes on
the second stage's run writes the files and metric keys that
``tests/test_pipeline_e2e.py`` asserts for the JAX package; ``realism`` on
a second stage fails with the JAX package's assertion; ``--test`` without
``--device cpu`` and without a card raises."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from ipoke_tpu_torch import main as cli
from ipoke_tpu_torch.cli import testing

from test_torch_cli import CONFIGS, SS, Env
from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

SS_TEST = dict(SS, testing={"n_samples_per_data_point": 2})


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env(tmp_path_factory.mktemp("cli_test"))
    for exp in ("img_encoder", "poke_encoder", "first_stage"):
        e.run(e.config(exp, CONFIGS[exp]))
    e.ss_path = e.config("second_stage", SS_TEST)
    e.run(e.ss_path)
    e.gen = os.path.join(e.base, "second_stage", "generated", "tiny")
    return e


def _test(env, mode):
    return env.run(env.ss_path, "--test", mode, "--debug")


def _metrics(env, mode, name="metrics.json"):
    with open(os.path.join(env.gen, mode, name)) as f:
        return json.load(f)


def test_samples(env):
    assert _test(env, "samples") == {"n_batches": 1.0}
    files = os.listdir(os.path.join(env.gen, "samples"))
    assert "grid_batch0.mp4" in files and "real_batch0.npy" in files
    assert any(f.startswith("enrollment_b0_s") and f.endswith(".png") for f in files)
    samples = np.load(os.path.join(env.gen, "samples", "samples_batch0.npy"))
    assert samples.shape == (2, 2, 3, 32, 32, 3)  # (B, S, T, H, W, 3)
    assert np.isfinite(samples).all()


def test_fvd(env):
    result = _test(env, "fvd")
    assert result == _metrics(env, "fvd", "fvd.json")
    assert np.isfinite(result["FVD"]) and result["n_samples"] == 4.0
    for name in ("real_samples.npy", "fake_samples.npy"):
        dump = np.load(os.path.join(env.gen, "fvd", name))
        assert dump.dtype == np.uint8 and dump.shape == (4, 3, 32, 32, 3)


def test_transfer(env):
    assert _test(env, "transfer") == {"n_transferred": 2.0}
    files = os.listdir(os.path.join(env.gen, "transfer"))
    assert "transfer_grid-0.mp4" in files and "transfer_batch0.npy" in files
    assert any(f.startswith("transfer_row-ids_m") and f.endswith(".mp4") for f in files)
    assert any(f.startswith("transfer_grid-ids_m") and f.endswith(".png") for f in files)


def test_control_sensitivity(env):
    result = _test(env, "control_sensitivity")
    assert result == _metrics(env, "control_sensitivity")
    assert set(result) == {"direction_correlation", "direction_correlation_swapped_debug",
                           "poke_region_response", "n_directions"}
    assert all(np.isfinite(v) for v in result.values()) and result["n_directions"] == 4.0
    d = os.path.join(env.gen, "control_sensitivity")
    sids = [f for f in os.listdir(d) if f.startswith("sid_")]
    assert sids
    inner = os.listdir(os.path.join(d, sids[0]))
    assert {"overview.mp4", "groundtruth_poke.mp4", "sample_4.mp4",
            "sample_4_enrollment.png"} <= set(inner)


def test_diversity(env):
    result = _test(env, "diversity")
    assert result == _metrics(env, "diversity")
    for key in ("divscore_mse", "divscore_vgg", "divscore_lpips"):
        assert np.isfinite(result[key]) and result[key] > 0, key


def test_accuracy(env):
    result = _test(env, "accuracy")
    assert result == _metrics(env, "accuracy")
    assert set(result) == {"ssim_best_of_n", "psnr_best_of_n", "lpips_best_of_n"}
    assert all(np.isfinite(v) for v in result.values())
    d = os.path.join(env.gen, "accuracy")
    assert os.path.exists(os.path.join(d, "per_frame_metrics.png"))
    with open(os.path.join(d, "per_frame_metrics.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "metric,frame,mean,std" and len(lines) == 1 + 3 * 3


def test_kps_acc(env):
    result = _test(env, "kps_acc")
    assert result == _metrics(env, "kps_acc")
    assert np.isfinite(result["kps_mse"]) and result["annotated_keypoints"] == 0.0


def test_realism_on_second_stage_raises(env):
    with pytest.raises(AssertionError, match="hallucinated-flow pipeline"):
        _test(env, "realism")


def test_third_stage_accuracy_dispatch(env, monkeypatch):
    """``accuracy`` on an experiment that evaluates hallucinated flow is the
    fork's flow-error mode, which waits for the FC third stage."""
    called = []
    monkeypatch.setattr(testing, "test_accuracy_third_stage",
                        lambda e: called.append(e) or {})

    class ThirdStage:
        evaluates_hallucinated_flow = True
        logger = logging.getLogger("ipoke_tpu_torch")

    assert testing.run_test(ThirdStage(), "accuracy") == {} and called


def test_test_mode_without_card_raises(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DATAPATH_BASE", env.base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["--config", env.ss_path, "--model_name", "tiny", "--test", "fvd"])
