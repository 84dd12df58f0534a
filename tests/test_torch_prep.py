"""The port's data prep (``ipoke_tpu_torch/data/prep.py``) against the JAX
package's (``ipoke_tpu/data/prep.py``), on the CPU:

* both packages' ``run(cfg)`` of ``config/data_preparation/iper.yaml``
  with Farneback over the same tiny raw tree (``tests/
  test_data_prep_configs.py``'s writer: 2 videos of 12 frames at 48 px,
  lags 2 and 4, pose input 32 px) write byte-equal frames, equal flows
  (the same cv2 call), equal ``meta.p`` index arrays and, from the same
  PoseResNet weights (a (1, 2, 1, 1)-stage torch-layout npz named by
  ``IPOKE_POSE_WEIGHTS`` for the port, its JAX variables for the JAX
  package), keypoints within 1e-4 and equal ``kp_nn``, in ``meta.p`` and
  ``meta_kp_nn.p``;
* the port's ``IperDataset`` reads the port's tree: ``keypoint_poke`` and
  ``keypoints_abs`` equal the JAX package's dataset on the JAX tree (its
  cv2 paths: ``IPOKE_NATIVE=0``);
* ``load_prep_config`` of the four YAMLs equals JAX's, under ``DATAPATH``;
* ``extract`` with ``flow_estimator: raft`` on the CPU writes finite
  (2, H, W) flows; ``main`` turns TF32 off and refuses ``cuda`` without a
  card.

The JAX pose net (jitted at its batch of 16) is this file's one program."""

import glob
import os
import pickle

import numpy as np
import pytest
import torch

from ipoke_tpu.data import datasets as jdatasets
from ipoke_tpu.data import prep as jprep
from ipoke_tpu.eval import pose as jpose
from ipoke_tpu_torch.data import datasets as tdatasets
from ipoke_tpu_torch.data import prep as tprep

from test_data_prep_configs import CONFIGS, _write_synthetic_videos
from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)
from test_torch_pose import LAYERS, _pose_npz, _variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IPER = os.path.join(REPO, "config", "data_preparation", "iper.yaml")
# 2 videos x (12 - 4) indexed frames: one pose batch of 16
SIZE, N_FRAMES = 48, 12


def _cfg(raw, processed, **kw):
    cfg = jprep.load_prep_config(IPER)
    cfg.update(dict(raw_dir=raw, processed_dir=processed, spatial_size=SIZE, flow_delta=2,
                    flow_max=4, num_workers=1, flow_estimator="farneback",
                    pose_input_size=32), **kw)
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The raw tree, prepared by both packages with the same pose weights."""
    root = tmp_path_factory.mktemp("prep")
    raw = str(root / "raw")
    _write_synthetic_videos(raw, n_frames=N_FRAMES, size=SIZE)
    values = _variables()
    npz = str(root / "pose.npz")
    _pose_npz(npz, values)
    mp = pytest.MonkeyPatch()
    mp.setenv("IPOKE_POSE_WEIGHTS", npz)
    # the JAX package reads a pose_resnet152 plan from the npz: hand it the
    # same weights as variables at the (1, 2, 1, 1) plan
    mp.setattr(jpose, "pose_estimator_from_env", lambda input_size, variables=None:
               jpose.PoseEstimator(variables=values, input_size=input_size, layers=LAYERS))
    try:
        jprep.run(_cfg(raw, str(root / "jax")))
        tprep.run(_cfg(raw, str(root / "port")), device="cpu")
    finally:
        mp.undo()
    return {"raw": raw, "jax": str(root / "jax"), "port": str(root / "port")}


def _files(d, pattern):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "*", pattern)))


def test_frames_and_flows_match_jax(trees):
    frames = _files(trees["port"], "frame_*.png")
    flows = _files(trees["port"], "prediction_*.flow.npy")
    assert len(frames) == 2 * N_FRAMES and len(flows) == 2 * (N_FRAMES - 4) * 2
    assert frames == _files(trees["jax"], "frame_*.png")
    assert flows == _files(trees["jax"], "prediction_*.flow.npy")
    for f in frames:
        with open(os.path.join(trees["port"], f), "rb") as a, \
                open(os.path.join(trees["jax"], f), "rb") as b:
            assert a.read() == b.read(), f
    for f in flows:
        got, want = (np.load(os.path.join(trees[k], f)) for k in ("port", "jax"))
        assert got.shape == (2, SIZE, SIZE) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["meta.p", "meta_kp_nn.p"])
def test_meta_matches_jax(trees, name):
    def load(k):
        with open(os.path.join(trees[k], name), "rb") as f:
            return pickle.load(f)

    got, want = load("port"), load("jax")
    assert set(got) == set(want) == {"img_path", "flow_paths", "fid", "vid", "object_id",
                                     "train", "keypoints", "kp_nn"}
    for k in want:
        if k == "keypoints":
            assert got[k].shape == (16, 17, 2) and got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], atol=1e-4)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.unique(got["keypoints"]).size > 3  # not a constant net


def test_iper_dataset_reads_port_tree(trees, monkeypatch):
    monkeypatch.setenv("IPOKE_NATIVE", "0")  # the JAX package's cv2 paths, as the port's
    cfg = dict(jprep.load_prep_config(IPER)["data"], spatial_size=(32, 32), max_frames=3,
               augment=False)
    keys = ["images", "keypoint_poke", "keypoints_abs"]
    port = tdatasets.IperDataset(cfg, keys, train=True, data_root=trees["port"])
    ref = jdatasets.IperDataset(cfg, keys, train=True, data_root=trees["jax"])
    assert len(port) == len(ref) > 0
    for i in range(3):
        got = port.get_item(i, np.random.default_rng(i))
        want = ref.get_item(i, np.random.default_rng(i))
        assert got["keypoints_abs"].shape == (4, 17, 2)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_prep_config_matches_jax(path, monkeypatch, tmp_path):
    assert tprep.load_prep_config(path) == jprep.load_prep_config(path)
    monkeypatch.setenv("DATAPATH", str(tmp_path))
    cfg = tprep.load_prep_config(path)
    assert cfg == jprep.load_prep_config(path)
    assert cfg["processed_dir"].startswith(str(tmp_path))
    assert isinstance(cfg["data"]["aug_trans"], tuple)


def test_extract_with_raft_on_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("IPOKE_RAFT_WEIGHTS", raising=False)
    raw, out = str(tmp_path / "raw"), str(tmp_path / "out")
    _write_synthetic_videos(raw, n_videos=1, n_frames=7, size=SIZE)
    tprep.extract(_cfg(raw, out, flow_estimator="raft"), device="cpu")
    flows = glob.glob(os.path.join(out, "vid_0", "prediction_*.flow.npy"))
    assert len(flows) == (7 - 4) * 2
    for f in flows:
        flow = np.load(f)
        assert flow.shape == (2, SIZE, SIZE) and flow.dtype == np.float32
        assert np.isfinite(flow).all()


def test_main_turns_tf32_off_and_needs_a_card(tmp_path, monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    out = str(tmp_path / "out")
    os.makedirs(out)
    assert tprep.main(["--config", IPER, "--processed_dir", out, "--mode", "prepare",
                       "--device", "cpu"]) == 0
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert os.path.exists(os.path.join(out, "meta.p"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.main(["--config", IPER, "--processed_dir", out, "--mode", "prepare"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.run(_cfg(str(tmp_path), out), mode="prepare")
