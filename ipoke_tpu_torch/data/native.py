"""ctypes bindings of the C++ loader helpers in ``native/ipoke_native.cpp``
(the port's own copy of ``ipoke_tpu/ops/native.py``): fused PNG decode +
RGB + bilinear resize, the fused ``.npy`` flow load + resize, the flow's
amplitude statistics, the single-pass clip colour jitter, and box and OKS
keypoint NMS.

The library is built at first use with ``g++`` (libpng and zlib linked
where a program can load them) into ``build/ipoke_tpu_torch/native/``, beside
the CUDA kernels' build, never into ``native/``, where the JAX package
builds its own.  ``IPOKE_NATIVE=0`` (the JAX package's switch) turns the
library off: ``decode_png``, ``load_flow`` and ``color_jitter_clip`` return
None and their callers take the cv2 / numpy path; the NMS functions and
``flow_amplitude_stats`` compute in numpy.  With the switch on a failed
build raises with the compiler's message; a PNG decode that the library
refuses (built without libpng: -100, or a file it cannot read) returns None,
and the caller takes the cv2 path, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "ipoke_native.cpp"
BUILD_DIR = ROOT / "build" / "ipoke_tpu_torch" / "native"
LIB = BUILD_DIR / "libipoke_native.so"

_lib = None
_lock = threading.Lock()
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)
_u8p = ctypes.POINTER(ctypes.c_ubyte)


def enabled() -> bool:
    return os.environ.get("IPOKE_NATIVE", "1") != "0"


_PNG_PROBE = "#include <png.h>\nint main() { return png_access_version_number() == 0; }\n"


def _png_flags(cxx: str):
    """The link flags of a libpng that a program can load and call (with an
    rpath to the directory the linker takes it from), or None.  A toolchain
    can link against a libpng that the loader then does not find."""
    where = subprocess.run([cxx, "-print-file-name=libpng.so"], capture_output=True,
                           text=True).stdout.strip()
    flags = ["-lpng", "-lz"]
    if os.path.isabs(where):
        flags.append(f"-Wl,-rpath,{os.path.dirname(os.path.realpath(where))}")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        exe = os.path.join(d, "probe")
        built = subprocess.run([cxx, "-x", "c++", "-", "-o", exe, *flags],
                               input=_PNG_PROBE, capture_output=True, text=True)
        if built.returncode != 0:
            return None
        return flags if subprocess.run([exe], capture_output=True).returncode == 0 \
            else None


def _replace(path: Path, write) -> None:
    """``write(tmp)`` to a new file beside ``path``, then one rename onto it,
    so that concurrent processes never read a half-written file."""
    fd, tmp = tempfile.mkstemp(suffix=path.suffix, dir=path.parent)
    os.close(fd)
    try:
        write(tmp)
    except BaseException:
        os.unlink(tmp)
        raise
    os.replace(tmp, path)


def build(force: bool = False) -> Path:
    """Compile the library when it is missing or older than its source (or
    ``force``).  Without a libpng that loads, the source is compiled as it
    is where ``png.h`` is absent: its PNG decode returns -100 and the
    loader takes cv2's."""
    if not force and LIB.exists() and LIB.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"IPOKE_NATIVE is on but the C++ compiler {cxx!r} is missing "
                           "(IPOKE_NATIVE=0 takes the cv2 / numpy paths)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    png, source = _png_flags(cxx), SOURCE
    if png is None:
        source = BUILD_DIR / "ipoke_native_nopng.cpp"
        text = SOURCE.read_text().replace("#if __has_include(<png.h>)", "#if 0", 1)
        _replace(source, lambda tmp: Path(tmp).write_text(text))

    def compile_to(tmp):
        cmd = [cxx, "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared",
               "-o", tmp, str(source), *(png or [])]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed ({' '.join(cmd)}):\n"
                               f"{res.stdout}{res.stderr}")

    _replace(LIB, compile_to)
    return LIB


def _load():
    """The library, built and bound at first use; None when switched off."""
    global _lib
    if not enabled():
        return None
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError:  # a library built on another host: build it here
                lib = ctypes.CDLL(str(build(force=True)))
            lib.nms_boxes.argtypes = [_f32p, _f32p, ctypes.c_int, ctypes.c_float,
                                      _i32p, _i32p]
            lib.nms_oks.argtypes = [_f32p, _f32p, _f32p, ctypes.c_int, ctypes.c_int,
                                    _f32p, ctypes.c_float, _i32p, _i32p]
            lib.load_flow_npy.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int]
            lib.load_flow_npy.restype = ctypes.c_int
            lib.flow_amplitude_stats.argtypes = [_f32p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_int, _f32p, _f32p, _f32p,
                                                 _f32p]
            lib.decode_png_rgb_resize.argtypes = [ctypes.c_char_p, _u8p,
                                                  ctypes.c_int, ctypes.c_int]
            lib.decode_png_rgb_resize.restype = ctypes.c_int
            lib.color_jitter_clip.argtypes = [_u8p, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_float,
                                              ctypes.c_float, ctypes.c_float,
                                              ctypes.c_float]
            lib.color_jitter_clip.restype = ctypes.c_int
            _lib = lib
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def decode_png(path: str, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """(out_h, out_w, 3) uint8 RGB of a PNG, bilinear with half-pixel
    centres like ``cv2.INTER_LINEAR`` (fixed-point rounding: at most one
    level from cv2), or None (switched off, built without libpng, or a file
    the library does not decode)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.decode_png_rgb_resize(str(path).encode(), out.ctypes.data_as(_u8p),
                                   out_h, out_w)
    return out if rc == 0 else None


def load_flow(path: str, out_h: int, out_w: int,
              scale_to_res: bool = False) -> Optional[np.ndarray]:
    """A (2, H, W) ``.npy`` flow as (out_h, out_w, 2) float32, bilinear
    resized (its magnitudes scaled to the new size with ``scale_to_res``),
    or None (switched off, or a file the library does not read)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 2), np.float32)
    rc = lib.load_flow_npy(str(path).encode(), _fp(out), out_h, out_w,
                           int(scale_to_res))
    return out if rc == 0 else None


def flow_amplitude_stats(flow: np.ndarray, margin: int = 0):
    """(mean, std, min, max) of the amplitude |flow| of an (H, W, 2) flow,
    ``margin`` pixels left out at each border: the mean and std of the
    amplitude min-max normalised (the reference's poke statistics), the min
    and max of the amplitude itself."""
    flow = np.ascontiguousarray(flow, np.float32)
    h, w = flow.shape[:2]
    lib = _load()
    if lib is None:
        amp = np.sqrt((flow ** 2).sum(-1))[margin:h - margin, margin:w - margin]
        mn, mx = float(amp.min()), float(amp.max())
        norm = (amp.astype(np.float64) - mn) / (mx - mn if mx > mn else 1.0)
        return float(norm.mean()), float(norm.std()), mn, mx
    out = [np.zeros(1, np.float32) for _ in range(4)]
    lib.flow_amplitude_stats(_fp(flow), h, w, margin, *(_fp(o) for o in out))
    return tuple(float(o[0]) for o in out)


def color_jitter_clip(clip_u8: np.ndarray, b: float, c: float, h: float,
                      s: float) -> Optional[np.ndarray]:
    """Brightness / contrast (a LUT) and HSV hue / saturation jitter in one
    pass over a (T, H, W, 3) uint8 clip, with cv2's and numpy's rounding (a
    new array), or None when switched off."""
    lib = _load()
    if lib is None:
        return None
    out = np.ascontiguousarray(clip_u8, np.uint8).copy()
    t, hh, ww, cc = out.shape
    assert cc == 3, out.shape
    # the hue offset scaled in float64, then rounded to fp32, as numpy
    # promotes it on the cv2 path
    rc = lib.color_jitter_clip(out.ctypes.data_as(_u8p), t, hh, ww, ctypes.c_float(b),
                               ctypes.c_float(c), ctypes.c_float(h * 180.0),
                               ctypes.c_float(s))
    return out if rc == 0 else None


def nms_boxes(boxes: np.ndarray, scores: np.ndarray,
              iou_thresh: float = 0.5) -> np.ndarray:
    """Greedy box NMS over (n, 4) [x1, y1, x2, y2]: the kept indices in
    descending score order."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = boxes.shape[0]
    lib = _load()
    if lib is not None:
        keep, n_keep = np.empty(n, np.int32), np.zeros(1, np.int32)
        lib.nms_boxes(_fp(boxes), _fp(scores), n, ctypes.c_float(iou_thresh),
                      _ip(keep), _ip(n_keep))
        return keep[:n_keep[0]].copy()
    order = np.argsort(-scores)
    keep, suppressed = [], np.zeros(n, bool)
    areas = np.maximum(0, boxes[:, 2] - boxes[:, 0]) * np.maximum(
        0, boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / (areas[i] + areas - inter + 1e-10)
        suppressed |= iou > iou_thresh
        suppressed[i] = True
    return np.asarray(keep, np.int32)


# the COCO keypoint sigmas (cycled past 17 joints)
_OKS_SIGMAS = np.asarray([0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
                          0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089,
                          0.089], np.float32)


def nms_oks(kps: np.ndarray, scores: np.ndarray, areas: np.ndarray,
            thresh: float = 0.9, sigmas: Optional[np.ndarray] = None) -> np.ndarray:
    """OKS NMS over pose candidates ``kps`` (n, k, 3): the kept indices in
    descending score order."""
    kps = np.ascontiguousarray(kps, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    areas = np.ascontiguousarray(areas, np.float32)
    n, k = kps.shape[:2]
    lib = _load()
    if lib is not None:
        keep, n_keep = np.empty(n, np.int32), np.zeros(1, np.int32)
        sp = _fp(np.ascontiguousarray(sigmas, np.float32)) if sigmas is not None \
            else ctypes.cast(None, _f32p)
        lib.nms_oks(_fp(kps), _fp(scores), _fp(areas), n, k, sp,
                    ctypes.c_float(thresh), _ip(keep), _ip(n_keep))
        return keep[:n_keep[0]].copy()
    if sigmas is None:
        sigmas = _OKS_SIGMAS[np.arange(k) % 17]

    def oks(a, b, area):
        d2 = (a[:, 0] - b[:, 0]) ** 2 + (a[:, 1] - b[:, 1]) ** 2
        return float(np.mean(np.exp(-d2 / (2 * area * (2 * sigmas) ** 2 + 1e-10))))

    order = np.argsort(-scores)
    suppressed, keep = np.zeros(n, bool), []
    for oi, i in enumerate(order):
        if suppressed[i]:
            continue
        keep.append(int(i))
        for j in order[oi + 1:]:
            if not suppressed[j] and oks(kps[i], kps[j], areas[i]) > thresh:
                suppressed[j] = True
    return np.asarray(keep, np.int32)
