"""The port's interactive poke UI (``ipoke_tpu_torch/ui/server.py``) on the
CPU, at toy size:

* ``main``'s build-and-restore route (``load_experiment``) restores the toy
  second stage that the port's CLI trained (``tests/test_torch_cli.py``'s
  pipeline, one epoch of 2 batches a stage): its flow params equal the
  best checkpoint's weights (bf16, upcast: a mixed run samples in fp32);
* that run served over real HTTP: ``GET /``, ``/frame``, ``POST /poke``
  (one PNG a frame), ``/save`` (the poked video, then on the first save of
  a frame the ground-truth clip and its simulated pokes' videos), a second
  save, and a save before any poke;
* against the JAX package's ``ui/server.py``, each through a stub model
  that records what it is handed, on the same numpy batches: the poke maps
  of the same requests (edges included) and of the saved ground-truth
  pokes are equal, and so are the saved files' names and layout.

No JAX program is compiled here."""

import base64
import json
import os
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from ipoke_tpu.data.synthetic import make_batch
from ipoke_tpu.ui import server as jserver
from ipoke_tpu_torch.core.checkpoint import CheckpointStore
from ipoke_tpu_torch.ui import server as tserver

from test_torch_cli import CONFIGS, SS, Env
from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env(tmp_path_factory.mktemp("ui"))
    for exp in ("img_encoder", "poke_encoder", "first_stage"):
        e.run(e.config(exp, CONFIGS[exp]))
    e.ss_path = e.config("second_stage", SS)
    e.run(e.ss_path)
    return e


@pytest.fixture(scope="module")
def restored(env):
    os.environ["DATAPATH_BASE"] = env.base
    try:
        return tserver.load_experiment(tserver.parse_args(
            ["--config", env.ss_path, "--model_name", "tiny", "--data_root", env.data,
             "--device", "cpu"]))
    finally:
        os.environ.pop("DATAPATH_BASE", None)


def test_main_route_restores_the_trained_run(env, restored):
    saved = CheckpointStore(env.run_dir("second_stage")["ckpt"]).restore_best(weights=True)
    got = restored.model.flow_params.state_dict()
    assert set(got) == set(saved) and len(saved) > 10
    assert {v.dtype for v in saved.values() if v.is_floating_point()} == {torch.bfloat16}
    for k, v in saved.items():
        if v.is_floating_point():
            assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_main_route_needs_a_card(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.load_experiment(tserver.parse_args(
            ["--config", env.ss_path, "--model_name", "tiny"]))


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=120).read()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=300).read())


def test_server_end_to_end(restored, tmp_path):
    httpd = tserver.serve(restored, port=0, display_size=64, background=True,
                          save_root=str(tmp_path))
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert "drag on the image to poke" in _get(base, "/").decode()
        frame = json.loads(_get(base, "/frame"))
        assert base64.b64decode(frame["frame"])[:8] == PNG
        out = _post(base, "/poke", {"x": 0.5, "y": 0.5, "dx": 0.2, "dy": -0.1})
        assert len(out["frames"]) == 3  # max_frames
        assert all(base64.b64decode(f)[:8] == PNG for f in out["frames"])
        saved = _post(base, "/save", {})
        names = {os.path.basename(f) for f in saved["files"]}
        assert {"vid_0.mp4", "vid_0_enrollment.png", "gt_vid.mp4",
                "gt_vid_enrollment.png", "gt_poke_vid_0.mp4", "gt_poke_vid_2.mp4"} <= names
        for f in saved["files"]:
            assert os.path.getsize(f) > 0, f
        # gui/id_<frame>: the /frame fetch advanced to id 1
        assert os.path.dirname(saved["files"][0]) == str(tmp_path / "gui" / "id_1")
        again = _post(base, "/save", {})
        assert {os.path.basename(f) for f in again["files"]} == {
            "vid_1.mp4", "vid_1_enrollment.png"}
        assert _get(base, "/")  # still serving
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_save_before_poke_reports_error(restored, tmp_path):
    httpd = tserver.serve(restored, port=0, display_size=64, background=True,
                          save_root=str(tmp_path))
    try:
        out = _post(f"http://127.0.0.1:{httpd.server_address[1]}", "/save", {})
        assert out["files"] == [] and "poke first" in out["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


# -- against the JAX package's server, through stub models --------------------

S, T = 32, 3
CONFIG = {"data": {"spatial_size": [S, S], "max_frames": T, "poke_size": 5}}
REQUESTS = [(0.5, 0.5, 0.2, -0.1), (0.0, 0.0, -0.3, 0.4), (0.999, 1.0, 0.05, 0.05),
            (0.03, 0.97, 1.0, -1.0)]


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def test_loader(self, n_batches=None):
        return iter(self.batches)


def _batches():
    rng = np.random.default_rng(0)
    return [make_batch(rng, batch_size=2, n_frames=T, spatial_size=S) for _ in range(3)]


def _video(images, poke):
    """(1, T, S, S, 3): the start frame shifted by the poke's mean."""
    return np.repeat(np.asarray(images)[:, :1], T, axis=1) + float(np.mean(poke))


def _jax_experiment(seen):
    class Model:
        def forward_sample(self, params, frozen, batch, rng, length):
            seen.append(np.asarray(batch["poke"][0]))
            return _video(batch["images"], batch["poke"])

    return SimpleNamespace(config=CONFIG, model=Model(), state=SimpleNamespace(params=None),
                           frozen=None, datamodule=_Loader(_batches()),
                           next_rng=lambda: jax.random.PRNGKey(0))


def _port_experiment(seen):
    class Model:
        def forward_sample(self, batch, length, generator):
            assert set(batch) == {"images", "poke"} and length == T
            seen.append(batch["poke"][0].numpy())
            return torch.from_numpy(_video(batch["images"].numpy(), batch["poke"].numpy()))

    return SimpleNamespace(config=CONFIG, model=Model(), device=torch.device("cpu"),
                           generator=None, datamodule=_Loader(_batches()))


def test_pokes_and_saved_layout_match_jax(tmp_path):
    seen_j, seen_t = [], []
    j = jserver.PokeSession(_jax_experiment(seen_j), 64, save_root=str(tmp_path / "jax"))
    t = tserver.PokeSession(_port_experiment(seen_t), 64, save_root=str(tmp_path / "port"))
    assert t.frame_png() == j.frame_png()
    files = {}
    for name, s in (("jax", j), ("port", t)):
        for req in REQUESTS:
            frames = s.poke(*req)
        assert len(frames) == T
        paths = s.save_current() + s.save_current()
        s.new_frame()
        s.poke(*REQUESTS[0])
        paths += s.save_current()
        files[name] = [os.path.relpath(p, tmp_path / name) for p in paths]
    assert files["port"] == files["jax"]
    assert files["port"][:2] == ["gui/id_0/vid_0.mp4", "gui/id_0/vid_0_enrollment.png"]
    assert len(seen_t) == len(seen_j) == len(REQUESTS) + 3 + 1 + 3  # pokes, GT pokes
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
    assert all(np.abs(p).max() > 0 for p in seen_t)  # every poke stamped
