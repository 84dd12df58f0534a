"""Synthetic moving-squares clips, the traffic's inputs: a frozen copy of
``ipoke_tpu_torch/data/synthetic.py::make_batch`` (the same draws from the
same numpy generator), kept here so that a change to the program cannot
change what the benchmark feeds it.  ``images`` (B, T+1, H, W, 3) in [-1,
1], ``flow`` and ``poke`` (B, H, W, 2)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_batch(rng: np.random.Generator, batch_size: int = 4,
               n_frames: int = 10, spatial_size: int = 64, poke_size: int = 5,
               n_pokes: int = 1) -> Dict[str, np.ndarray]:
    """A batch of squares moving with constant per-sample velocity."""
    B, T, S = batch_size, n_frames, spatial_size
    imgs = np.full((B, T + 1, S, S, 3), -1.0, np.float32)
    flow = np.zeros((B, S, S, 2), np.float32)
    poke = np.zeros((B, S, S, 2), np.float32)
    poke_coords = np.zeros((B, n_pokes, 2), np.int32)
    for b in range(B):
        size = int(rng.integers(S // 8, S // 4))
        x0 = int(rng.integers(0, S - size))
        y0 = int(rng.integers(0, S - size))
        vmax = max(1, S // (2 * T))
        vx = int(rng.integers(-vmax, vmax + 1))
        vy = int(rng.integers(-vmax, vmax + 1))
        color = rng.uniform(-0.2, 1.0, size=3).astype(np.float32)
        for t in range(T + 1):
            xs = np.clip(x0 + vx * t, 0, S - size)
            ys = np.clip(y0 + vy * t, 0, S - size)
            imgs[b, t, ys:ys + size, xs:xs + size] = color
        flow[b, y0:y0 + size, x0:x0 + size, 0] = vx * T
        flow[b, y0:y0 + size, x0:x0 + size, 1] = vy * T
        for n in range(n_pokes):
            py = int(rng.integers(y0, y0 + size))
            px = int(rng.integers(x0, x0 + size))
            half = poke_size // 2
            y1, y2 = max(0, py - half), min(S, py + half + 1)
            x1, x2 = max(0, px - half), min(S, px + half + 1)
            poke[b, y1:y2, x1:x2] = flow[b, py, px]
            poke_coords[b, n] = (py, px)
    return {"images": imgs, "flow": flow, "poke": poke,
            "poke_coords": poke_coords}
