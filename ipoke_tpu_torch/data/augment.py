"""Data augmentation (host-side, numpy/cv2; a copy of
``ipoke_tpu/data/augment.py``: the clip colour jitter through the fused
native pass of ``data/native.py``, else, and under ``IPOKE_NATIVE=0``,
through numpy and cv2).

Replicates the reference's coherent per-sample color and geometric transforms
(``data/base_dataset.py:694-721``): brightness/contrast/hue/saturation with
per-sample probability ``p_col``, and rotation+translation with reflect
padding at ``p_geom``.  The same sampled geometric transform is applied to
every frame AND to the flow field (with vector rotation) so poke/flow stay
consistent with the video.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class _ColorTransform:
    def __init__(self, brightness, contrast, hue, saturation):
        self.b, self.c, self.h, self.s = brightness, contrast, hue, saturation

    @property
    def is_identity(self) -> bool:
        """True when the probability gate failed and no jitter was sampled —
        the reference applies NO transform in that case
        (base_dataset.py:694-721), so callers skip the work entirely."""
        return (self.b == 1.0 and self.c == 1.0 and self.h == 0.0
                and self.s == 1.0)

    def __call__(self, img_u8: np.ndarray) -> np.ndarray:
        return self.apply_clip(img_u8[None])[0]

    def apply_clip(self, clip_u8: np.ndarray) -> np.ndarray:
        """Vectorized over a (T, H, W, C) uint8 clip — the loader's hottest
        python path after PNG decode.

        Brightness+contrast are a per-frame 256-entry LUT instead of two
        full-image float round-trips: since the per-pixel map depends only on
        the input value and the frame's post-brightness mean, the mean is
        taken from the frame HISTOGRAM weighted by the float brightness
        values (identical to the float path's mean up to summation order),
        and the fused map ``clip((clip(x*b) - mean)*c + mean)`` is tabulated
        once per frame.  Hue/saturation then use ONE HSV conversion for the
        whole clip (cvtColor is per-pixel, so the (T*H, W, C) reshape is
        exact)."""
        import cv2

        if self.is_identity:
            return clip_u8
        from .native import color_jitter_clip  # the fused single pass

        out = color_jitter_clip(clip_u8, self.b, self.c, self.h, self.s)
        if out is not None:
            return out
        t, hh, ww, cc = clip_u8.shape
        img = clip_u8
        if self.b != 1.0 or self.c != 1.0:
            x = np.arange(256, dtype=np.float32)
            lut_b = np.clip(x * self.b, 0.0, 255.0)          # float brightness
            flat = clip_u8.reshape(t, -1)
            out = np.empty_like(flat)
            for i in range(t):
                hist = np.bincount(flat[i], minlength=256)
                mean = np.float32(
                    float(hist.astype(np.float64) @ lut_b.astype(np.float64))
                    / flat[i].size)
                lut = np.clip((lut_b - mean) * self.c + mean,
                              0.0, 255.0).astype(np.uint8)
                out[i] = lut[flat[i]]
            img = out.reshape(t, hh, ww, cc)
        if self.h != 0.0 or self.s != 1.0:
            hsv = cv2.cvtColor(img.reshape(t * hh, ww, cc),
                               cv2.COLOR_RGB2HSV).astype(np.float32)
            hsv[..., 0] = (hsv[..., 0] + self.h * 180.0) % 180.0
            hsv[..., 1] = np.clip(hsv[..., 1] * self.s, 0, 255)
            img = cv2.cvtColor(hsv.astype(np.uint8),
                               cv2.COLOR_HSV2RGB).reshape(t, hh, ww, cc)
        return img


class ColorAugment:
    def __init__(self, config: dict):
        self.p = float(config.get("p_col", 0.0))
        self.ab = float(config.get("augment_b", 0.0))
        self.ac = float(config.get("augment_c", 0.0))
        self.ah = float(config.get("augment_h", 0.0))
        self.a_s = float(config.get("augment_s", 0.0))

    def sample(self, rng: np.random.Generator) -> Optional[_ColorTransform]:
        if rng.random() >= self.p:
            return _ColorTransform(1.0, 1.0, 0.0, 1.0)
        b = 1.0 + (rng.uniform(-self.ab, self.ab) if self.ab > 0 else 0.0)
        c = 1.0 + (rng.uniform(-self.ac, self.ac) if self.ac > 0 else 0.0)
        h = rng.uniform(-self.ah, 2 * self.ah) if self.ah > 0 else 0.0
        s = 1.0 + (rng.uniform(-self.a_s, self.a_s) if self.a_s > 0 else 0.0)
        return _ColorTransform(b, c, h, s)


class _GeomTransform:
    def __init__(self, angle_deg: float, tx: int, ty: int):
        self.angle = angle_deg
        self.tx, self.ty = tx, ty

    @property
    def is_identity(self) -> bool:
        """True when the probability gate failed — skip warpAffine entirely
        (the reference applies no transform in that case)."""
        return self.angle == 0.0 and self.tx == 0 and self.ty == 0

    def _warp(self, img: np.ndarray, is_flow: bool) -> np.ndarray:
        import cv2

        if self.is_identity:
            return img
        h, w = img.shape[:2]
        m = cv2.getRotationMatrix2D((w / 2, h / 2), self.angle, 1.0)
        m[0, 2] += self.tx
        m[1, 2] += self.ty
        border = cv2.BORDER_REFLECT if not is_flow else cv2.BORDER_CONSTANT
        out = cv2.warpAffine(
            img, m, (w, h), flags=cv2.INTER_LINEAR, borderMode=border
        )
        return out

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return self._warp(img, is_flow=False)

    def apply_flow(self, flow: np.ndarray) -> np.ndarray:
        """Warp the flow field and rotate the vectors with it."""
        out = self._warp(flow, is_flow=True)
        rad = np.deg2rad(self.angle)
        c, s = np.cos(rad), np.sin(rad)
        fx = c * out[..., 0] + s * out[..., 1]
        fy = -s * out[..., 0] + c * out[..., 1]
        return np.stack([fx, fy], axis=-1)


class GeometricAugment:
    def __init__(self, config: dict):
        self.p = float(config.get("p_geom", 0.0))
        self.deg = float(config.get("aug_deg", 0.0))
        self.trans = tuple(config.get("aug_trans", (0.0, 0.0)))
        self.size = tuple(config["spatial_size"])

    def sample(self, rng: np.random.Generator) -> Optional[_GeomTransform]:
        if rng.random() >= self.p:
            return _GeomTransform(0.0, 0, 0)
        ang = rng.uniform(-self.deg, self.deg) if self.deg > 0 else 0.0
        ty = (int(rng.integers(-int(self.trans[0] * self.size[1] / 2),
                               int(self.trans[0] * self.size[1] / 2) + 1))
              if self.trans[0] > 0 else 0)
        tx = (int(rng.integers(-int(self.trans[1] * self.size[0] / 2),
                               int(self.trans[1] * self.size[0] / 2) + 1))
              if self.trans[1] > 0 else 0)
        return _GeomTransform(ang, tx, ty)
