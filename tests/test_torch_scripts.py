"""The conv-side root scripts' counterparts (``ipoke_tpu_torch/scripts/``)
against the JAX scripts on the same synthetic files, and MotionFeatureNet's
training pieces against ``ipoke_tpu/nn/motion_feat.py``.  This file's one
JAX program is the JAX diversity script's jitted VGG."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import data_analysis as jax_data_analysis
import iper_loader_test as jax_loader_test
import testing_evaluate_diversity as jax_diversity
from ipoke_tpu.nn import motion_feat as jmf
from ipoke_tpu_torch.data.prep import make_synthetic_dataset
from ipoke_tpu_torch.data.synthetic import make_batch
from ipoke_tpu_torch.nn import motion_feat as tmf
from ipoke_tpu_torch.scripts import (data_analysis, iper_loader_test,
                                     testing_eval_models, testing_evaluate_diversity,
                                     train_motion_feat)

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)
from test_torch_testing import weights_env  # noqa: F401 (the VGG npz)


def _jax_main(module, monkeypatch, capsys, *argv):
    """A JAX root script's ``main`` on ``argv``; its standard output."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("scripts") / "data"
    make_synthetic_dataset(str(root), n_videos=4, n_frames=14, spatial_size=32,
                           flow_delta=4)
    return root


def test_data_analysis_matches_jax(tree, tmp_path, monkeypatch, capsys):
    """The printed statistics and the preview PNGs byte for byte."""
    want = _jax_main(jax_data_analysis, monkeypatch, capsys, "--processed_dir",
                     str(tree), "--out_dir", str(tmp_path / "jax"))
    assert data_analysis.main(["--processed_dir", str(tree), "--out_dir",
                               str(tmp_path / "port")]) == 0
    assert capsys.readouterr().out == want
    stats = data_analysis.analyse(str(tree))
    assert f"mean={stats['mean']:.3f}" in want and stats["n_files"] > 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes()


def test_loader_sweep_matches_jax(tree, monkeypatch, capsys):
    want = _jax_main(jax_loader_test, monkeypatch, capsys, "--data_root", str(tree),
                     "--dataset", "PlantDataset", "--spatial_size", "32",
                     "--n_batches", "2")
    iper_loader_test.main(["--data_root", str(tree), "--dataset", "PlantDataset",
                           "--spatial_size", "32", "--n_batches", "2"])
    assert capsys.readouterr().out == want


def test_diversity_matches_jax(tmp_path, weights_env, monkeypatch, capsys):  # noqa: F811
    """MSE and VGG diversity of two sample dumps within 1e-5, the same
    VGG19 npz on both sides (``IPOKE_VGG_WEIGHTS``)."""
    for k, v in weights_env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(3)
    base = rng.uniform(-1, 1, (1, 1, 2, 32, 32, 3))
    for i in range(2):
        s = np.clip(base + 0.2 * rng.standard_normal((2, 3, 2, 32, 32, 3)), -1, 1)
        np.save(tmp_path / f"samples_batch{i}.npy", s.astype(np.float32))
    want = json.loads(_jax_main(jax_diversity, monkeypatch, capsys, "--samples_dir",
                                str(tmp_path)))
    got = testing_evaluate_diversity.evaluate(str(tmp_path), device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_eval_models_commands(tmp_path, monkeypatch):
    """One ``python -m ipoke_tpu_torch.main --test`` per model and mode;
    a failed one makes the script fail."""
    names = tmp_path / "models.txt"
    names.write_text("# runs\nrun_a\n\nrun_b\n")
    calls = []

    def fake_run(cmd):
        calls.append(cmd)
        return type("R", (), {"returncode": 3 if cmd[cmd.index("--test") + 1] == "fvd"
                              and "run_b" in cmd else 0})()

    monkeypatch.setattr(testing_eval_models.subprocess, "run", fake_run)
    rc = testing_eval_models.main(["--models", str(names), "--config", "c.yaml",
                                   "--tests", "fvd", "diversity", "--data_root", "D",
                                   "--device", "cpu"])
    assert rc == 1
    assert [c[c.index("--model_name") + 1] + "/" + c[c.index("--test") + 1]
            for c in calls] == ["run_a/fvd", "run_a/diversity", "run_b/fvd",
                                "run_b/diversity"]
    for c in calls:
        assert c[:3] == [sys.executable, "-m", "ipoke_tpu_torch.main"]
        assert c[c.index("--config") + 1] == "c.yaml"
        assert c[c.index("--device") + 1] == "cpu" and c[-2:] == ["--data_root", "D"]


def test_motion_targets_match_jax():
    flow = make_batch(np.random.default_rng(4), batch_size=3, n_frames=2,
                      spatial_size=32)["flow"]
    flow[0] = 0.0  # a clip without motion
    np.testing.assert_array_equal(tmf.motion_targets(flow), jmf.motion_targets(flow))


def test_trained_npz_loads_in_both(tmp_path):
    """Two pretext steps of the port's trainer, its npz saved; both
    packages' ``load_motion_feat`` give the same activations (1e-5), the
    heads' too."""
    logs = []
    net = train_motion_feat.train(2, batch=2, frames=4, spatial=32, device="cpu",
                                  log=logs.append)
    assert "order-acc" in logs[-1]
    path = str(tmp_path / "mf.npz")
    tmf.save_motion_feat(net, path)
    params = jmf.load_motion_feat(path, frames=4, spatial=32)
    v = np.random.default_rng(6).uniform(-1, 1, (3, 4, 32, 32, 3)).astype(np.float32)
    feat, motion, order = jmf.MotionFeatureNet().apply(params, jnp.asarray(v),
                                                       return_heads=True)
    got = tmf.motion_feat_activations(tmf.load_motion_feat(path), v)
    np.testing.assert_allclose(got, np.asarray(feat), atol=1e-5, rtol=1e-5)
    ref = tmf.MotionFeatureNet(heads=True)
    ref.load_state_dict({k: v.half().float() for k, v in net.state_dict().items()})
    with torch.no_grad():
        _, m, o = ref(torch.as_tensor(v), return_heads=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(motion), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(order), atol=1e-5, rtol=1e-5)
