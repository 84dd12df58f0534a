"""The port's native loader helpers (``ipoke_tpu_torch/data/native.py``)
against the JAX package's bindings (``ipoke_tpu/ops/native.py``) on the same
files and arrays: PNG decode and the colour jitter byte for byte, NMS index
lists exactly, the flow loader within 1e-6; each also against the cv2 /
numpy path within the tolerance the JAX package's own tests hold
(``tests/test_native.py``).  Then the switch, the build's failure and the
library's -100 ("no libpng")."""

import cv2
import numpy as np
import pytest

from ipoke_tpu.ops import native as jnative
from ipoke_tpu_torch.data import native
from ipoke_tpu_torch.data.augment import _ColorTransform

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)


@pytest.fixture(autouse=True)
def _on(monkeypatch):
    monkeypatch.setenv("IPOKE_NATIVE", "1")


def _png(tmp_path, shape, seed):
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / f"img{seed}.png")
    assert cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return img, path


@pytest.mark.parametrize("src,out", [((64, 48, 3), (64, 48)), ((256, 256, 3), (128, 128)),
                                     ((256, 256, 3), (96, 80))])
def test_decode_png(tmp_path, src, out):
    """Byte-equal to the JAX binding; against cv2.imread + resize: equal at
    the same size and at 256 -> 128 px, within one level on at most 15% of
    the pixels otherwise (cv2's 11-bit fixed-point weights)."""
    img, path = _png(tmp_path, src, sum(out))
    got = native.decode_png(path, *out)
    np.testing.assert_array_equal(got, jnative.decode_png(path, *out))
    ref = cv2.resize(img, out[::-1], interpolation=cv2.INTER_LINEAR)
    diff = np.abs(got.astype(int) - ref.astype(int))
    if out == (96, 80):
        assert diff.max() <= 1 and (diff == 0).mean() > 0.85
    else:
        assert diff.max() == 0


def test_load_flow_and_stats(tmp_path, monkeypatch):
    """The flow loader within 1e-6 of the JAX binding and 1e-4 of np.load +
    cv2.resize (magnitudes rescaled); the amplitude stats against numpy."""
    flow = np.random.default_rng(2).normal(0, 3, (2, 48, 40)).astype(np.float32)
    path = str(tmp_path / "f.flow.npy")
    np.save(path, flow)
    got = native.load_flow(path, 32, 32, scale_to_res=True)
    np.testing.assert_allclose(got, jnative.load_flow(path, 32, 32, True), atol=1e-6)
    ref = cv2.resize(np.transpose(flow / (48 / 32.0), (1, 2, 0)), (32, 32),
                     interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert native.load_flow(str(tmp_path / "missing.npy"), 8, 8) is None
    stats = native.flow_amplitude_stats(got, margin=2)
    monkeypatch.setenv("IPOKE_NATIVE", "0")
    np.testing.assert_allclose(stats, native.flow_amplitude_stats(got, margin=2),
                               rtol=1e-5)


def test_color_jitter(monkeypatch):
    """Byte-equal to the JAX binding; against the numpy / cv2 path within
    one level on at most 10% of the values (cv2's own u8 HSV paths differ by
    one), exact where only brightness and contrast move (a LUT)."""
    clip = np.random.default_rng(5).integers(0, 256, (3, 32, 40, 3), np.uint8)
    for b, c, h, s in ((1.3, 0.7, 0.0, 1.0), (1.0, 1.0, 0.08, 1.3),
                       (0.7, 1.4, -0.1, 0.6), (1.0, 1.0, 0.3, 1.0)):
        got = native.color_jitter_clip(clip, b, c, h, s)
        np.testing.assert_array_equal(got, jnative.color_jitter_clip(clip, b, c, h, s))
        np.testing.assert_array_equal(_ColorTransform(b, c, h, s).apply_clip(clip), got)
        monkeypatch.setenv("IPOKE_NATIVE", "0")
        want = _ColorTransform(b, c, h, s).apply_clip(clip.copy())
        monkeypatch.setenv("IPOKE_NATIVE", "1")
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= (0 if (h, s) == (0.0, 1.0) else 1)
        assert (diff == 0).mean() > 0.9


def test_nms(monkeypatch):
    """Box and OKS NMS: the index lists of the JAX binding and of the numpy
    path, exactly."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 50, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (60, 2))], 1).astype(np.float32)
    scores = rng.uniform(size=60).astype(np.float32)
    base = rng.uniform(0, 60, (8, 17, 3))
    kps = np.concatenate([base + rng.normal(0, 0.5, base.shape) for _ in range(3)]
                         ).astype(np.float32)
    ks, areas = rng.uniform(size=24).astype(np.float32), np.full(24, 400, np.float32)
    got = native.nms_boxes(boxes, scores, 0.5), native.nms_oks(kps, ks, areas, 0.5)
    assert len(got[0]) < 60 and len(got[1]) < 24
    for a, b in zip(got, (jnative.nms_boxes(boxes, scores, 0.5),
                          jnative.nms_oks(kps, ks, areas, 0.5))):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("IPOKE_NATIVE", "0")
    for a, b in zip(got, (native.nms_boxes(boxes, scores, 0.5),
                          native.nms_oks(kps, ks, areas, 0.5))):
        np.testing.assert_array_equal(a, b)


def jnative_source():
    from pathlib import Path

    return Path(native.__file__).resolve().parents[2] / "native" / "ipoke_native.cpp"


def test_switch_build_failure_and_no_png(tmp_path, monkeypatch):
    """``IPOKE_NATIVE=0`` returns None from the decoders; with the switch on a
    failed build raises with the compiler's message; where no libpng loads
    the library is built without it, its decode (-100) returns None, and
    the dataset takes cv2's pixels."""
    _, path = _png(tmp_path, (16, 16, 3), 7)
    monkeypatch.setenv("IPOKE_NATIVE", "0")
    assert native.decode_png(path, 16, 16) is None
    assert native.load_flow(path, 8, 8) is None
    assert native.color_jitter_clip(np.zeros((1, 4, 4, 3), np.uint8), 1.2, 1, 0, 1) is None
    monkeypatch.setenv("IPOKE_NATIVE", "1")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken(;\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="broken"):
        native.decode_png(path, 16, 16)

    # a toolchain whose libpng no program can load: the source built as
    # without png.h, its decode returns -100
    monkeypatch.setattr(native, "SOURCE", jnative_source())
    monkeypatch.setattr(native, "LIB", tmp_path / "build" / "nopng.so")
    monkeypatch.setattr(native, "_png_flags", lambda cxx: None)
    assert native.decode_png(path, 16, 16) is None
    assert (tmp_path / "build" / "ipoke_native_nopng.cpp").exists()
    flow = np.ones((2, 8, 8), np.float32)
    np.save(tmp_path / "f.npy", flow)
    np.testing.assert_array_equal(native.load_flow(str(tmp_path / "f.npy"), 8, 8),
                                  np.ones((8, 8, 2), np.float32))
    from ipoke_tpu_torch.data.datasets import VideoDataset

    ds = VideoDataset.__new__(VideoDataset)
    ds.spatial_size = (12, 12)
    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(ds._decode_img(path, False),
                                  cv2.resize(img, (12, 12), interpolation=cv2.INTER_LINEAR))
