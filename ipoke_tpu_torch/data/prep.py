"""Offline data preparation (counterpart of ``ipoke_tpu/data/prep.py``;
reference ``data/prepare_dataset.py``).

    python -m ipoke_tpu_torch.data.prep --config config/data_preparation/iper.yaml
        [--mode extract|prepare|pose_estimation|all] [--raw_dir D]
        [--processed_dir D] [--flow_delta N] [--flow_max N]
        [--spatial_size N] [--flow_estimator raft|farneback]
        [--num_workers N] [--device cuda|cpu]

``extract`` decodes each raw video, resizes its frames to ``spatial_size``
and writes ``frame_<i>.png`` and a ``prediction_<i>_<j>.flow.npy`` (2, H, W)
for every lag ``j - i`` of the ``flow_delta``..``flow_max`` grid;
``prepare`` walks the processed tree and writes the ``meta.p`` index;
``pose_estimation`` (iPER, or when asked for) writes the keypoints and
their nearest neighbours into ``meta.p`` and ``meta_kp_nn.p``; ``all`` runs
the chain.  The flow estimators take a uint8 RGB pair and the run's device:
``farneback`` (cv2, on the CPU whatever the device) and ``raft``
(``nn/raft.py::raft_estimator``, on the device; ``IPOKE_RAFT_WEIGHTS`` names
an official checkpoint's npz, else a fixed-seed net); more can be added
with ``register_flow_estimator``.  The YAMLs' ``input_size`` is read by
neither package.  The pose net is ``IPOKE_POSE_WEIGHTS``' or a fixed-seed
ResNet-50 (``eval/pose.py``).  The run's device defaults to ``cuda`` and a
run asked for ``cuda`` raises without a card; TF32 is off under ``main``.
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing as mp
import os
import pickle
import re
from typing import Callable, Dict, List, Optional

import numpy as np

_FLOW_ESTIMATORS: Dict[str, Callable] = {}


def register_flow_estimator(name: str, fn: Callable):
    """``fn(img1, img2, device)``: uint8 RGB (H, W, 3) frames -> float32
    flow (2, H, W)."""
    _FLOW_ESTIMATORS[name] = fn


def _farneback(img1: np.ndarray, img2: np.ndarray, device=None) -> np.ndarray:
    import cv2

    g1 = cv2.cvtColor(img1, cv2.COLOR_RGB2GRAY)
    g2 = cv2.cvtColor(img2, cv2.COLOR_RGB2GRAY)
    flow = cv2.calcOpticalFlowFarneback(
        g1, g2, None, pyr_scale=0.5, levels=4, winsize=21, iterations=3,
        poly_n=7, poly_sigma=1.5, flags=0,
    )
    return np.transpose(flow, (2, 0, 1)).astype(np.float32)  # (2, H, W)


register_flow_estimator("farneback", _farneback)


def _raft(img1: np.ndarray, img2: np.ndarray, device="cuda") -> np.ndarray:
    from ..nn.raft import raft_estimator

    return raft_estimator(img1, img2, device)


register_flow_estimator("raft", _raft)


def extract_video(
    video_path: str, out_dir: str, flow_delta: int = 10,
    spatial_size: Optional[int] = None, estimator: str = "farneback",
    frames_discr: int = 1, flow_max: Optional[int] = None, device="cuda",
):
    """Decode frames (every ``frames_discr``-th, resized to
    ``spatial_size``) and estimate the flow from frame i to i + lag for
    every lag of the ``flow_delta``..``flow_max`` grid (e.g. 10 and 30:
    lags 10, 20 and 30) on ``device``; returns the number of frames."""
    import cv2

    est = _FLOW_ESTIMATORS[estimator]
    lags = (list(range(flow_delta, int(flow_max) + 1, flow_delta))
            if flow_max else [flow_delta])
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    frames = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % frames_discr == 0:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if spatial_size:
                frame = cv2.resize(frame, (spatial_size, spatial_size))
            frames.append(frame)
        i += 1
    cap.release()
    for i, frame in enumerate(frames):
        cv2.imwrite(
            os.path.join(out_dir, f"frame_{i}.png"),
            cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
        )
    for i in range(len(frames) - lags[-1]):
        for lag in lags:
            flow = est(frames[i], frames[i + lag], device)
            np.save(
                os.path.join(out_dir, f"prediction_{i}_{i + lag}.flow.npy"),
                flow,
            )
    return len(frames)


def extract(config: dict, device="cuda"):
    """``extract_video`` over ``raw_dir``'s videos (``*.<video_format>``)
    into ``processed_dir/<video name>``.  With ``num_workers`` above 1 the
    videos fan out over a pool of processes started with ``spawn`` (a
    forked process cannot use CUDA), each running its estimator on
    ``device``."""
    fmt = config.get("video_format")
    pattern = f"*.{fmt}" if fmt else "*"
    videos = sorted(glob.glob(os.path.join(config["raw_dir"], pattern)))
    out_root = config["processed_dir"]
    n_workers = int(config.get("num_workers", 1))
    jobs = [
        (v, os.path.join(out_root, os.path.splitext(os.path.basename(v))[0]),
         int(config.get("flow_delta", 10)), config.get("spatial_size"),
         config.get("flow_estimator", "farneback"),
         int(config.get("frames_discr", 1)), config.get("flow_max"), str(device))
        for v in videos
    ]
    if n_workers <= 1:
        for j in jobs:
            extract_video(*j)
    else:
        with mp.get_context("spawn").Pool(n_workers) as pool:
            pool.starmap(extract_video, jobs)


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


def pose_estimation(processed_dir: str, meta_path: Optional[str] = None,
                    batch_size: int = 16, input_size: int = 64,
                    pose_net=None, device="cuda") -> dict:
    """Keypoints of every indexed frame (resized to ``input_size``, batches
    of ``batch_size``) by ``pose_net`` (an ``eval.pose.PoseResNet``; else
    ``pose_estimator_from_env``'s) on ``device``, and each frame's keypoint
    nearest neighbour in another video, written into the meta pickle and
    ``meta_kp_nn.p`` (reference ``prepare_dataset.py:461-516``).  The
    datasets recompute the neighbours per split."""
    import cv2

    from ..eval.pose import (
        PoseEstimator,
        keypoint_nearest_neighbors,
        pose_estimator_from_env,
    )

    meta_path = meta_path or os.path.join(processed_dir, "meta.p")
    with open(meta_path, "rb") as f:
        meta = pickle.load(f)
    est = PoseEstimator(pose_net.to(device)) if pose_net is not None \
        else pose_estimator_from_env(device)
    paths = [os.path.join(processed_dir, str(p)) for p in meta["img_path"]]
    kps_all = []
    for i in range(0, len(paths), batch_size):
        frames = []
        for p in paths[i : i + batch_size]:
            img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (input_size, input_size))
            frames.append(img.astype(np.float32) / 127.5 - 1.0)
        kps_all.append(est(np.stack(frames)))
    kps = np.concatenate(kps_all, axis=0)
    meta["keypoints"] = kps
    meta["kp_nn"] = keypoint_nearest_neighbors(kps, np.asarray(meta["vid"]))
    for path in (os.path.join(processed_dir, "meta_kp_nn.p"), meta_path):
        with open(path, "wb") as f:
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



def load_prep_config(path: str) -> dict:
    """A data-preparation YAML (``config/data_preparation/*.yaml``): the prep
    parameters at the top level and a ``data:`` block for the datasets.
    ``!!python/tuple`` loads as a tuple; ``raw_dir`` and ``processed_dir``
    are re-rooted under ``$DATAPATH`` when it is set."""
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_constructor(
        "tag:yaml.org,2002:python/tuple",
        lambda loader, node: tuple(loader.construct_sequence(node)))
    with open(path) as f:
        cfg = yaml.load(f, Loader=_Loader)
    datapath = os.environ.get("DATAPATH")
    if datapath:
        for k in ("raw_dir", "processed_dir"):
            if cfg.get(k):
                cfg[k] = os.path.join(datapath, cfg[k].lstrip("/"))
    return cfg


def run(config: dict, mode: Optional[str] = None, device="cuda"):
    """The extract -> prepare -> pose_estimation chain of a prep config on
    ``device``; pose estimation under ``all`` for iPER only (reference
    ``prepare_dataset.py:557-572``)."""
    from ..main import check_device

    check_device(device)
    mode = mode or config.get("mode", "all")
    if mode not in ("extract", "prepare", "pose_estimation", "all"):
        raise ValueError(f"unknown prep mode {mode!r}")
    if mode in ("extract", "all"):
        if not config.get("raw_dir"):
            raise ValueError("raw_dir required for extract")
        extract(config, device)
    if mode in ("prepare", "all"):
        prepare(config["processed_dir"])
    if mode in ("pose_estimation", "all") and (
            mode == "pose_estimation"
            or config.get("data", {}).get("dataset") == "IperDataset"):
        pose_estimation(config["processed_dir"],
                        input_size=int(config.get("pose_input_size", 64)),
                        device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description="offline dataset preparation")
    p.add_argument("--config", help="data_preparation YAML")
    p.add_argument("--mode",
                   choices=["extract", "prepare", "pose_estimation", "all"],
                   default=None)
    p.add_argument("--raw_dir")
    p.add_argument("--processed_dir")
    p.add_argument("--flow_delta", type=int, default=None)
    p.add_argument("--flow_max", type=int, default=None)
    p.add_argument("--spatial_size", type=int, default=None)
    p.add_argument("--flow_estimator", default=None)
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from ..main import check_device

    check_device(args.device)
    import torch

    # fp32 convolutions and products without TF32, as main.run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_prep_config(args.config) if args.config else {}
    for k in ("raw_dir", "processed_dir", "flow_delta", "flow_max",
              "spatial_size", "flow_estimator", "num_workers"):
        v = getattr(args, k)
        if v is not None:
            cfg[k] = v
    cfg.setdefault("flow_delta", 10)
    cfg.setdefault("flow_estimator", "farneback")
    if not cfg.get("processed_dir"):
        p.error("--processed_dir (or processed_dir in --config) required")
    run(cfg, args.mode, args.device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
