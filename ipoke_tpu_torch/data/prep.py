"""Offline dataset preparation, the part the port's runs need (a copy of
``ipoke_tpu/data/prep.py``'s ``prepare`` and ``make_synthetic_dataset``):
the synthetic moving-square tree in the on-disk artifact format (PNG
frames, ``prediction_<i>_<j>.flow.npy``, ``meta.p``).  Frame extraction,
the flow estimators (RAFT, Farneback) and pose estimation are not ported.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np

_FRAME_RE = re.compile(r"frame_(\d+)\.png$")
_FLOW_RE = re.compile(r"prediction_(\d+)_(\d+)\.flow\.npy$")


def prepare(processed_dir: str, meta_path: Optional[str] = None,
            train_fraction: float = 0.8, rel_paths: bool = True) -> dict:
    """Walk the processed tree and build the ``meta.p`` index
    (reference ``prepare``, prepare_dataset.py:264-415)."""
    meta = {k: [] for k in
            ("img_path", "flow_paths", "fid", "vid", "object_id", "train")}
    vid_dirs = sorted(
        d for d in glob.glob(os.path.join(processed_dir, "*")) if os.path.isdir(d)
    )
    n_train = int(round(train_fraction * len(vid_dirs)))
    for vid, d in enumerate(vid_dirs):
        frames = sorted(
            glob.glob(os.path.join(d, "frame_*.png")),
            key=lambda p: int(_FRAME_RE.search(p).group(1)),
        )
        flows: Dict[int, List[str]] = {}
        for f in glob.glob(os.path.join(d, "prediction_*.flow.npy")):
            m = _FLOW_RE.search(f)
            flows.setdefault(int(m.group(1)), []).append(f)
        # rows must be rectangular: only frames carrying the full lag grid
        # (multi-lag extraction, flow_max/flow_delta) enter the index —
        # matches the reference, whose per-frame flow list is dense
        n_lags = max((len(v) for v in flows.values()), default=0)
        for fid, frame in enumerate(frames):
            if len(flows.get(fid, ())) != n_lags:
                continue
            # ascending lag order (sort by end-frame index j of i->j)
            row = sorted(flows[fid],
                         key=lambda p: int(_FLOW_RE.search(p).group(2)))
            rel = (lambda p: os.path.relpath(p, processed_dir)) if rel_paths \
                else (lambda p: p)
            meta["img_path"].append(rel(frame))
            meta["flow_paths"].append([rel(p) for p in row])
            meta["fid"].append(fid)
            meta["vid"].append(vid)
            meta["object_id"].append(vid)
            meta["train"].append(vid < n_train)
    meta = {k: np.asarray(v) for k, v in meta.items()}
    if meta_path is None:
        meta_path = os.path.join(processed_dir, "meta.p")
    with open(meta_path, "wb") as f:
        pickle.dump(meta, f)
    return meta



def make_synthetic_dataset(root: str, n_videos: int = 4, n_frames: int = 16,
                           spatial_size: int = 64, seed: int = 0,
                           flow_delta: int = 5) -> dict:
    """Write a synthetic moving-square dataset in the on-disk artifact format
    (frames + .flow.npy + meta.p) — the CI stand-in for real data."""
    import cv2

    rng = np.random.default_rng(seed)
    S = spatial_size
    for v in range(n_videos):
        d = os.path.join(root, f"vid_{v:03d}")
        os.makedirs(d, exist_ok=True)
        size = int(rng.integers(S // 8, S // 4))
        x0, y0 = int(rng.integers(0, S - size)), int(rng.integers(0, S - size))
        vel = rng.integers(-2, 3, size=2)
        color = rng.integers(64, 255, size=3)
        for t in range(n_frames):
            img = np.zeros((S, S, 3), np.uint8)
            xs = int(np.clip(x0 + vel[0] * t, 0, S - size))
            ys = int(np.clip(y0 + vel[1] * t, 0, S - size))
            img[ys : ys + size, xs : xs + size] = color
            cv2.imwrite(os.path.join(d, f"frame_{t}.png"), img[..., ::-1])
        for t in range(n_frames - flow_delta):
            flow = np.zeros((2, S, S), np.float32)
            xs = int(np.clip(x0 + vel[0] * t, 0, S - size))
            ys = int(np.clip(y0 + vel[1] * t, 0, S - size))
            flow[0, ys : ys + size, xs : xs + size] = vel[0] * flow_delta
            flow[1, ys : ys + size, xs : xs + size] = vel[1] * flow_delta
            np.save(
                os.path.join(d, f"prediction_{t}_{t + flow_delta}.flow.npy"),
                flow,
            )
    return prepare(root)
