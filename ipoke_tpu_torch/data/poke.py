"""Poke simulation — the semantic contract of the poke API (a copy of
``ipoke_tpu/data/poke.py``).

Host-side numpy port of the reference's thresholding logic
(``data/base_dataset.py:505-646`` ``_get_poke``), kept behaviorally exact:

* flow amplitude over the valid (margin-cropped) region, min/max normalized;
* candidate poke pixels: amplitude > mean + 2*std, falling back to
  mean + std and then mean when empty;
* n_pokes ~ U{1, min(n_pokes_max, #candidates)} unless fixed;
* poke map = flow value stamped into a poke_size^2 window at each center;
* zero-poke branch (idx -1): poke *locations* come from background pixels
  (amplitude < 5th percentile), poke *values* from high-motion pixels
  (amplitude > mean + std), and the target flow is all-zero — teaching
  foreground/background separation.

This stays on host (per-sample dynamic control flow, SURVEY.md §7 hard part
6); only dense tensors cross to the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class FlowError(Exception):
    """No valid poke candidates / corrupt flow (reference base_dataset.py:17)."""


def flow_amplitude(flow: np.ndarray, margin: int) -> np.ndarray:
    """Min/max-normalized magnitude over the valid region.

    flow: (H, W, 2) -> amplitude (H - 2*margin, W - 2*margin).
    """
    h, w = flow.shape[:2]
    valid = flow[margin : h - margin, margin : w - margin]
    amp = np.linalg.norm(valid, axis=-1)
    amp = amp - amp.min()
    mx = amp.max()
    if mx > 0:
        amp = amp / mx
    return amp


def simulate_poke(
    flow: np.ndarray,
    rng: np.random.Generator,
    n_pokes_max: int,
    poke_size: int,
    zero_poke: bool = False,
    fix_n_pokes: bool = False,
    equal_poke_val: bool = True,
    foreground_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (poke_map (H, W, 2), poke_centers (n_pokes_max, 2) int32,
    unused slots = -1)."""
    h, w = flow.shape[:2]
    margin = poke_size
    amp = flow_amplitude(flow, margin)

    if foreground_mask is not None:
        m = foreground_mask[margin : h - margin, margin : w - margin]
        amp_filt = np.where(m, amp, 0.0)
    else:
        amp_filt = amp

    if zero_poke:
        # locations: background; values: high-motion pixels
        amp_filt = amp
        if foreground_mask is not None:
            bg = np.logical_not(
                foreground_mask[margin : h - margin, margin : w - margin]
            )
            loc_idx = np.stack(np.nonzero(bg), axis=-1)
            if loc_idx.shape[0] == 0:
                loc_idx = np.stack(
                    np.nonzero(amp <= np.percentile(amp, 5)), axis=-1
                )
        else:
            loc_idx = np.stack(np.nonzero(amp <= np.percentile(amp, 5)), axis=-1)
        mean, std = amp_filt.mean(), amp_filt.std()
        val_idx = np.stack(np.nonzero(amp_filt > mean + std), axis=-1)
        if val_idx.shape[0] == 0:
            val_idx = np.stack(np.nonzero(amp_filt > mean), axis=-1)
        if val_idx.shape[0] == 0:
            # a clip without motion has no value to poke with: the loader
            # draws another (the JAX package fails here in numpy)
            raise FlowError("Empty poke-value set: the flow has no motion")
        val_idx = val_idx + margin
        cand_idx = loc_idx
    else:
        mean, std = amp_filt.mean(), amp_filt.std()
        cand_idx = np.stack(np.nonzero(amp_filt > mean + 2.0 * std), axis=-1)
        if cand_idx.shape[0] == 0:
            cand_idx = np.stack(np.nonzero(amp > mean + std), axis=-1)
            if cand_idx.shape[0] == 0:
                cand_idx = np.stack(np.nonzero(amp > mean), axis=-1)
        val_idx = None

    cand_idx = cand_idx + margin
    if cand_idx.shape[0] == 0:
        raise FlowError("Empty poke-candidate set")

    if fix_n_pokes or n_pokes_max == 1:
        n_pokes = n_pokes_max
    else:
        n_pokes = int(rng.integers(1, min(n_pokes_max, cand_idx.shape[0]) + 1))

    sel = rng.integers(0, cand_idx.shape[0], size=n_pokes)
    rows, cols = cand_idx[sel, 0], cand_idx[sel, 1]
    if zero_poke:
        sel_v = rng.integers(0, val_idx.shape[0], size=n_pokes)
        vrows, vcols = val_idx[sel_v, 0], val_idx[sel_v, 1]

    half = poke_size // 2
    poke = np.zeros_like(flow)
    centers = np.full((n_pokes_max, 2), -1, np.int32)
    for n in range(n_pokes):
        r, c = int(rows[n]), int(cols[n])
        if zero_poke:
            vr, vc = int(vrows[n]), int(vcols[n])
            target = (
                flow[vr, vc]
                if equal_poke_val
                else flow[vr - half : vr + half + 1, vc - half : vc + half + 1]
            )
        else:
            target = (
                flow[r, c]
                if equal_poke_val
                else flow[r - half : r + half + 1, c - half : c + half + 1]
            )
        poke[r - half : r + half + 1, c - half : c + half + 1] = target
        centers[n] = (r, c)
    return poke, centers


def scale_flow_to_res(flow: np.ndarray, target_size: int) -> np.ndarray:
    """Rescale flow magnitudes for a resized video
    (reference ``base_dataset.py:671-672``: divide by src_h / target_h)."""
    return flow / (flow.shape[0] / float(target_size))


def resize_flow(flow: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, 2) flow field."""
    import cv2

    return cv2.resize(flow, (size[1], size[0]), interpolation=cv2.INTER_LINEAR)
