"""The port's numpy + cv2 artifact helpers against the JAX package's, on
arrays from numpy seeds:

* ``utils/video.py``: ``to_uint8``, ``flow_to_rgb`` and ``make_grid``
  bitwise; the mp4 and enrollment writers produce their files;
* the per-frame errorbar CSV of ``--test accuracy`` (``metric,frame,mean,
  std``) and the keypoint-error CSVs (pandas' ``to_csv`` of the per-frame
  frame and of its per-Time group means) equal when parsed, the figures
  written (PNG; PDF holding the raster);
* ``--test control_sensitivity``'s Farneback response, equal."""

import csv
import os

import numpy as np
import pytest

from ipoke_tpu.cli import testing as jtesting
from ipoke_tpu.utils import latent_viz as jviz
from ipoke_tpu.utils import plots as jplots
from ipoke_tpu.utils import video as jvideo
from ipoke_tpu_torch.cli import testing as ttesting
from ipoke_tpu_torch.utils import latent_viz as tviz
from ipoke_tpu_torch.utils import plots as tplots
from ipoke_tpu_torch.utils import video as tvideo


def _video(seed, shape=(4, 3, 16, 16, 3)):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, shape).astype(np.float32)


def test_to_uint8_flow_to_rgb_make_grid_bitwise():
    v = _video(0)
    np.testing.assert_array_equal(tvideo.to_uint8(v), jvideo.to_uint8(v))
    flow = (3 * np.random.default_rng(1).standard_normal((16, 16, 2))).astype(np.float32)
    for max_mag in (None, 2.0):
        np.testing.assert_array_equal(tvideo.flow_to_rgb(flow, max_mag),
                                      jvideo.flow_to_rgb(flow, max_mag))
    frames = tvideo.to_uint8(v[:, 0])
    for n_per_row in (2, 3):
        np.testing.assert_array_equal(tvideo.make_grid(frames, n_per_row),
                                      jvideo.make_grid(frames, n_per_row))


def test_grids_and_writers(tmp_path):
    v = _video(2)
    poke = np.zeros((4, 16, 16, 2), np.float32)
    poke[:, 6:9, 6:9] = (2.0, -1.0)
    flow = _video(3, (4, 16, 16, 2))
    paths = [tvideo.make_flow_video_grid(v[:, 0], poke, [v, v], v, flow,
                                         str(tmp_path / "grid.mp4")),
             tvideo.save_enrollment(v[0], str(tmp_path / "enr.png")),
             tvideo.make_transfer_grid(v, v[:, 0], v, str(tmp_path / "transfer.mp4"),
                                       extra=[v])]
    singles = tvideo.make_multipoke_grid(v[0, 0], poke, v[0], v[:, None].repeat(1, 1)[:, 0],
                                         str(tmp_path / "multi.mp4"))
    assert len(singles) == 4
    for p in paths + [str(tmp_path / "multi.mp4")]:
        assert os.path.getsize(p) > 0, p
    np.testing.assert_array_equal(
        tvideo.draw_poke_arrows(v[0, 0], poke[0]), jvideo.draw_poke_arrows(v[0, 0], poke[0]))


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_same_csv(got, want):
    """The same header, index, keys and numbers once parsed."""
    g, w = _rows(got), _rows(want)
    assert g[0] == w[0] and len(g) == len(w)
    for a, b in zip(g[1:], w[1:]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            try:
                assert float(x) == float(y), (x, y)
            except ValueError:
                assert x == y


def test_errorbar_csvs_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    per_frame = {"ssim": rng.random((5, 3)).astype(np.float32),
                 "psnr": 30 * rng.random((5, 3)).astype(np.float32),
                 "lpips": rng.random((5, 3)).astype(np.float32)}
    tviz.plot_metric_errorbars(per_frame, str(tmp_path / "t.png"), str(tmp_path / "t.csv"))
    jviz.plot_metric_errorbars(per_frame, str(tmp_path / "j.png"), str(tmp_path / "j.csv"))
    _assert_same_csv(str(tmp_path / "t.csv"), str(tmp_path / "j.csv"))
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()
    assert os.path.getsize(tmp_path / "t.png") > 0

    # the keypoint artifact set of --test accuracy
    kps = (rng.random((6, 4)) ** 3).astype(np.float32)
    frame = {"Time": np.tile(np.arange(4), 6), "Mean MSE per Frame": kps.reshape(-1),
             "Std per Frame": np.tile(kps.std(axis=0), 6), "Number of Pokes": [2] * kps.size}
    df = jplots._as_df(frame)
    df.to_csv(tmp_path / "j_frame.csv")
    df.groupby("Time", as_index=False).mean(numeric_only=True).to_csv(tmp_path / "j_group.csv")
    tplots.to_csv(frame, str(tmp_path / "t_frame.csv"))
    tplots.to_csv(tplots.group_mean(frame, "Time"), str(tmp_path / "t_group.csv"))
    _assert_same_csv(str(tmp_path / "t_frame.csv"), str(tmp_path / "j_frame.csv"))
    _assert_same_csv(str(tmp_path / "t_group.csv"), str(tmp_path / "j_group.csv"))
    pdf = str(tmp_path / "plot.pdf")
    tplots.make_errorbar_plot(pdf, frame, xid="Time", yid="Mean MSE per Frame",
                              hueid="Number of Pokes", varid="Std per Frame")
    with open(pdf, "rb") as f:
        data = f.read()
    assert data.startswith(b"%PDF-1.4") and data.rstrip().endswith(b"%%EOF")


@pytest.mark.parametrize("yx", [(8, 8), (0, 15)])
def test_generated_motion_direction_matches_jax(yx):
    rng = np.random.default_rng(5)
    x0 = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
    xT = np.roll(x0, (1, 2), axis=(0, 1))
    np.testing.assert_array_equal(ttesting._generated_motion_direction(x0, xT, *yx),
                                  jtesting._generated_motion_direction(x0, xT, *yx))


def test_aligned_joints_refuses_layout_mismatch():
    a, b = np.zeros((2, 17, 2)), np.zeros((2, 14, 2))
    for mod in (ttesting, jtesting):
        assert mod._aligned_joints(a, a)[0] is a
        with pytest.raises(ValueError, match="layout mismatch"):
            mod._aligned_joints(a, b)
