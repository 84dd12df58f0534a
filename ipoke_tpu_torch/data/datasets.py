"""Video datasets over the reference's on-disk artifact contract (a copy of
``ipoke_tpu/data/datasets.py``: PNG frames and ``.npy`` flows through the
native decoders of ``data/native.py`` where they take the file, else, and
under ``IPOKE_NATIVE=0``, through cv2 and numpy).

L1 of the framework (SURVEY.md §2.2): a ``meta.p``-indexed dataset with
datakey-driven item assembly (reference ``data/base_dataset.py:109-239``) and
the four per-dataset subclasses (``data/flow_dataset.py``).  Differences by
design:

* host-side pure numpy, channels-last, every sample drawn through an explicit
  ``np.random.Generator`` (worker-reproducible; replaces the reference's
  global-RNG nondeterminism, SURVEY.md §5.2);
* images come out (T+1, H, W, 3) float32 in [-1, 1]; flow (H, W, 2); poke
  (H, W, 2) + centers — the exact batch contract of the reference collate.

On-disk artifact contract (produced by ``ipoke_tpu_torch.data.prep``):
  <root>/<video_dir>/frame_<i>.png
  <root>/<video_dir>/prediction_<i>_<i+lag>.flow.npy     # (2, H, W)
  <root>/meta.p   # pickle: img_path, flow_paths, fid, vid, object_id, train
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .augment import ColorAugment, GeometricAugment
from .poke import FlowError, resize_flow, scale_flow_to_res, simulate_poke


DATAKEYS = (
    "images", "poke", "flow", "original_flow", "sample_ids", "app_img_random",
    "img_aT", "img_sT", "app_img_dis", "app_img_cmp",
    "keypoints_abs", "keypoints_rel", "keypoint_poke", "nn",
)


def compute_flow_mask(flow: np.ndarray, quantile: float = 0.75) -> np.ndarray:
    """Foreground mask from flow magnitude (reference
    ``_compute_mask_with_flow``, base_dataset.py:341-349)."""
    mag = np.linalg.norm(flow, axis=-1)
    thresh = np.quantile(mag, quantile)
    return mag > max(thresh, 1e-6)


def compute_grabcut_mask(img_u8: np.ndarray, iters: int = 3) -> np.ndarray:
    """grabCut foreground mask over the center region (reference
    ``_compute_mask``, base_dataset.py:325-339); offline/eval use."""
    import cv2

    h, w = img_u8.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    rect = (w // 8, h // 8, w * 3 // 4, h * 3 // 4)
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    cv2.grabCut(img_u8, mask, rect, bgd, fgd, iters, cv2.GC_INIT_WITH_RECT)
    return (mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)


def flow_path_frame_gaps(flow_paths_row) -> np.ndarray:
    """Frame gaps encoded in flow filenames (``prediction_<i>_<j>.flow.npy``
    -> j - i), reference flow_dataset.py:63,103-117."""
    gaps = []
    for p in flow_paths_row:
        stem = os.path.basename(str(p)).split(".")[0]
        parts = stem.split("_")
        try:
            gaps.append(int(parts[-1]) - int(parts[-2]))
        except (ValueError, IndexError):
            gaps.append(-1)
    return np.asarray(gaps)


class VideoDataset:
    subsample_step = 1
    flow_cutoff = 1.0
    obj_weighting = False
    filter_flow_default = False
    use_flow_for_weights = True  # mask source: flow magnitude vs grabCut
    flow_width_factor = 5
    use_lanczos = False
    default_lag = 0

    def __init__(self, config: dict, datakeys: Sequence[str], train: bool = True,
                 meta: Optional[dict] = None, data_root: Optional[str] = None):
        assert len(datakeys) > 0
        unknown = [k for k in datakeys if k not in DATAKEYS]
        assert not unknown, f"invalid datakeys: {unknown}"
        self.config = config
        self.datakeys = list(datakeys)
        self.train = train
        self.spatial_size = tuple(config["spatial_size"])
        self.max_frames = int(config.get("max_frames", 10))
        self.poke_size = int(
            config.get("poke_size", self.spatial_size[0] / 128 * 10)
        )
        self.n_pokes = int(config.get("n_pokes", 1))
        self.fix_n_pokes = bool(config.get("fix_n_pokes", False)) or (
            self.n_pokes == 1
        )
        self.equal_poke_val = bool(config.get("equal_poke_val", True))
        self.scale_poke_to_res = bool(config.get("scale_poke_to_res", False))
        self.filter_flow = bool(config.get("filter_flow",
                                           self.filter_flow_default))
        if "use_flow_for_weights" in config:
            self.use_flow_for_weights = bool(config["use_flow_for_weights"])
        self.split = config.get("split", "official")
        self.filter_proc = config.get("filter", "all")
        self.fancy_aug = bool(config.get("fancy_aug", False))
        self.augment = bool(config.get("augment", False)) and train
        self.normalize_01 = bool(config.get("01_normalize", False))
        self.max_trials_flow_load = 50

        self.color_aug = ColorAugment(config) if self.augment else None
        self.geom_aug = GeometricAugment(config) if self.augment else None

        data_root = data_root or config.get("data_root")
        # Decoded-frame cache (FFCV-style): datasets store 256px PNGs
        # (prep layout, ref data/prepare_dataset.py) but train at
        # spatial_size — every epoch re-pays zlib inflate + resize for the
        # same bytes.  `frame_cache: raw` writes each frame's decoded
        # (H, W, 3) uint8 once and mmap-reads it afterwards (bit-exact by
        # construction; ~50 KB/frame at 128px).  Opt-in: real datasets can
        # be large and the cache trades disk for a ~6x per-core loader
        # speedup (PERFORMANCE.md "Host input pipeline").
        self.frame_cache = str(config.get("frame_cache", "none"))
        self.frame_cache_dir = config.get("frame_cache_dir") or (
            os.path.join(data_root, ".frame_cache") if data_root else None)
        if meta is None:
            with open(os.path.join(data_root, "meta.p"), "rb") as f:
                meta = pickle.load(f)
        self.data_root = data_root
        self._build_index(meta, data_root)
        self._set_instance_specific_values()
        self._select_lag()
        # variable-length chunking thresholds (reference flow_dataset.py:
        # 161-163); kept for parity — like the reference's live fixed-length
        # path, nothing consumes it unless variable-length sampling is used
        self.seq_len_T_chunk = {
            l: c for l, c in enumerate(np.linspace(
                0, self.flow_cutoff, self.max_frames, endpoint=False))
        }
        self.seq_len_T_chunk[self.max_frames] = self.flow_cutoff

    # -- index ---------------------------------------------------------------
    def _build_index(self, meta: dict, data_root: Optional[str]):
        dd = {k: np.asarray(v) for k, v in meta.items()}
        dd = self._filter_data(dd)
        keep = self._make_split(dd)
        if keep is not None:
            dd = {k: v[keep] for k, v in dd.items()}
        if data_root is not None:
            join = np.vectorize(lambda p: os.path.join(data_root, str(p)))
            dd["img_path"] = join(dd["img_path"])
            dd["flow_paths"] = join(dd["flow_paths"])
        if dd["flow_paths"].ndim == 1:
            dd["flow_paths"] = dd["flow_paths"][:, None]
        # order flow columns naturally by their frame gap (reference
        # flow_dataset.py:73-74 natsorted)
        if dd["flow_paths"].shape[1] > 1:
            order = np.argsort(flow_path_frame_gaps(dd["flow_paths"][0]))
            dd["flow_paths"] = dd["flow_paths"][:, order]
        self.datadict = dd
        # per-video last frame index (global ids)
        vids = dd["vid"]
        self.seq_end_id = np.empty(len(vids), np.int64)
        self.sids_per_seq = {}
        for v in np.unique(vids):
            idx = np.flatnonzero(vids == v)
            self.seq_end_id[idx] = idx.max()
            self.sids_per_seq[v] = idx.min()
        self.valid_lags = [self.default_lag]

    def _filter_data(self, dd: dict) -> dict:
        """Pre-split filter procedures (reference flow_dataset.py:133-138:
        'action' keeps action_id==2, 'pose' keeps action_id==1)."""
        if self.filter_proc in ("action", "pose") and "action_id" in dd:
            want = 2 if self.filter_proc == "action" else 1
            sel = dd["action_id"] == want
            if sel.any():
                dd = {k: v[sel] for k, v in dd.items()}
        return dd

    def _make_split(self, dd: dict) -> Optional[np.ndarray]:
        """Index array of this split (train/test), or None for all.

        Base behavior: the ``train`` flag in the meta pickle (reference
        VegetationDataset/TaichiDataset/Human36mDataset 'official' splits,
        flow_dataset.py:338-350,588-604)."""
        if "train" in dd and dd["train"].size:
            sel = dd["train"].astype(bool)
            if not self.train:
                sel = ~sel
            if sel.any():
                return np.flatnonzero(sel)
        return None

    def _split_per_group(self, dd: dict, key: str,
                         frac: float = 0.8) -> np.ndarray:
        """First 80% of each group's frames -> train (reference per-video
        fallback split, flow_dataset.py:452-470)."""
        groups = dd.get(key, dd["vid"])
        train_idx, test_idx = [], []
        for g in np.unique(groups):
            idx = np.flatnonzero(groups == g)
            cut = int(frac * idx.shape[0])
            train_idx.append(idx[:cut])
            test_idx.append(idx[cut:])
        return np.sort(np.concatenate(train_idx if self.train else test_idx))

    def _set_instance_specific_values(self):
        pass

    def _select_lag(self):
        """Pick the flow column whose frame gap matches the clip span
        ``(n_ref_frames or max_frames) * subsample_step`` (reference
        flow_dataset.py:100-119).  Falls back to the class default when no
        column matches (e.g. single-lag synthetic data)."""
        gaps = flow_path_frame_gaps(self.datadict["flow_paths"][0])
        n_ref = int(self.config.get("n_ref_frames", self.max_frames))
        target = n_ref * self.subsample_step
        hit = np.flatnonzero(gaps == target)
        if hit.size:
            self.valid_lags = [int(hit[0])]
        else:
            self.valid_lags = [
                min(self.default_lag, self.datadict["flow_paths"].shape[1] - 1)
            ]

    def __len__(self):
        return int(self.datadict["img_path"].shape[0])

    # -- sampling -------------------------------------------------------------
    def _get_valid_ids(self, index: int, rng: np.random.Generator) -> Tuple[int, int]:
        """(start_id, length_flag); index==-1 requests a zero-poke sample
        (reference base_dataset.py:264-288)."""
        length = 0
        if index == -1:
            length = -1
            if self.obj_weighting and "weights" in self.datadict:
                w = self.datadict["weights"]
                index = int(rng.choice(len(w), p=w / w.sum()))
            else:
                index = int(rng.integers(0, len(self)))
        start = min(
            index,
            int(self.seq_end_id[index]) - self.max_frames * self.subsample_step - 1,
        )
        start = max(start, int(self.sids_per_seq[self.datadict["vid"][index]]))
        return start, length

    # -- loaders ---------------------------------------------------------------
    def _frame_cache_path(self, path: str, lanczos: bool) -> str:
        h, w = self.spatial_size
        tag = "lz" if lanczos else "ln"
        rel = os.path.relpath(path, self.data_root) if self.data_root else \
            os.path.basename(path)
        rel = rel.replace(os.sep, "__")
        return os.path.join(self.frame_cache_dir,
                            f"{rel}.{h}x{w}.{tag}.rgb8")

    def _load_img(self, path: str) -> np.ndarray:
        # Human3.6m resizes with lanczos, but ONLY at spatial_size 64 —
        # the reference gates it (flow_dataset.py:584 use_lanczos;
        # base_dataset.py:411 `use_lanczos and spatial_size == 64`)
        use_lanczos = self.use_lanczos and self.spatial_size[0] == 64
        path = str(path)
        cpath = None
        if self.frame_cache == "raw" and self.frame_cache_dir:
            cpath = self._frame_cache_path(path, use_lanczos)
            h, w = self.spatial_size
            try:
                if os.path.getmtime(cpath) >= os.path.getmtime(path):
                    img = np.fromfile(cpath, np.uint8)
                    if img.size == h * w * 3:
                        return img.reshape(h, w, 3)
            except OSError:
                pass  # miss (or stale/truncated): decode below and refill
        img = self._decode_img(path, use_lanczos)
        if cpath is not None:
            try:
                os.makedirs(self.frame_cache_dir, exist_ok=True)
                tmp = f"{cpath}.{os.getpid()}.{threading.get_ident()}.tmp"
                img.tofile(tmp)
                os.replace(tmp, cpath)  # atomic: concurrent workers race safely
            except OSError:
                pass  # cache is best-effort (full/read-only disk)
        return img

    def populate_frame_cache(self) -> int:
        """Decode every indexed frame once into the raw cache (one-time,
        like offline prep); returns the number of frames now cached."""
        assert self.frame_cache == "raw" and self.frame_cache_dir
        n = 0
        for p in np.unique(self.datadict["img_path"]):
            self._load_img(str(p))
            n += 1
        return n

    def _decode_img(self, path: str, use_lanczos: bool) -> np.ndarray:
        if not use_lanczos and path.lower().endswith(".png"):
            # fused native decode + RGB + bilinear resize (one pass)
            from .native import decode_png

            img = decode_png(path, self.spatial_size[0], self.spatial_size[1])
            if img is not None:
                return img
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FlowError(f"could not read image {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        interp = cv2.INTER_LANCZOS4 if use_lanczos else cv2.INTER_LINEAR
        img = cv2.resize(
            img, (self.spatial_size[1], self.spatial_size[0]),
            interpolation=interp,
        )
        return img

    def _get_imgs(self, ids, rng, color_t=None, geom_t=None,
                  fb_aug: bool = False):
        """fb_aug = the reference's ``fancy_aug``/``use_fb_aug``
        (base_dataset.py:405-440): on the first and last frames, the
        BACKGROUND (outside the grabCut foreground mask of the start frame)
        gets an independently-sampled color transform — appearance
        disentanglement without touching the moving subject."""
        start, length = ids
        frame_ids = [
            start + i * self.subsample_step for i in range(self.max_frames + 1)
        ]
        frame_ids = [min(f, int(self.seq_end_id[start])) for f in frame_ids]
        fg_mask = None
        if fb_aug:
            fg_mask = self._grabcut_cached(int(frame_ids[0]))
        # decode per frame (cv2 releases the GIL), then augment/normalize the
        # whole (T, H, W, C) stack at once — clip-level color jitter + ONE
        # float conversion, the loader's hottest python path after PNG decode
        clip = np.stack(
            [self._load_img(self.datadict["img_path"][f]) for f in frame_ids],
            axis=0)
        if color_t is not None and not color_t.is_identity:
            clip = color_t.apply_clip(clip)
        if fb_aug:
            for i in (0, len(frame_ids) - 1):
                bt = self.color_aug.sample(rng) if self.color_aug else None
                if bt is not None:
                    img_back = bt(clip[i])
                    clip[i] = np.where(fg_mask[..., None], clip[i], img_back)
        if geom_t is not None and not geom_t.is_identity:
            clip = np.stack([geom_t(img) for img in clip], axis=0)
        out = clip.astype(np.float32) / 255.0
        if not self.normalize_01:
            out = out * 2.0 - 1.0
        return out

    def _load_flow(self, ids) -> np.ndarray:
        start, length = ids
        path = self.datadict["flow_paths"][start, self.valid_lags[0]]
        # fused native load + resize (+ the magnitudes' rescale)
        from .native import load_flow

        out = load_flow(str(path), self.spatial_size[0], self.spatial_size[1],
                        self.scale_poke_to_res)
        if out is not None:
            return out
        try:
            raw = np.load(path)
        except ValueError:
            try:
                raw = np.load(path, allow_pickle=True)
            except Exception as e:
                raise FlowError(f"{path}: {e}")
        except Exception as e:
            raise FlowError(f"{path}: {e}")
        flow = np.transpose(raw, (1, 2, 0)).astype(np.float32)  # (H, W, 2)
        if self.scale_poke_to_res:
            flow = scale_flow_to_res(flow, self.spatial_size[0])
        flow = resize_flow(flow, self.spatial_size)
        return flow

    def _get_flow(self, ids, rng, geom_t=None, always_original=False):
        flow = self._load_flow(ids if ids[1] != -1 else (ids[0], 0))
        if ids[1] == -1 and not always_original:
            flow = np.zeros_like(flow)
        if geom_t is not None and ids[1] != -1:
            flow = geom_t.apply_flow(flow)
        return flow

    def _get_fg_mask(self, ids, flow):
        """Foreground mask for poke-candidate filtering (reference
        ``_get_mask``, base_dataset.py:351-360): flow-magnitude mask when
        ``use_flow_for_weights`` (h36m) else grabCut over the start frame
        (iPER/taichi)."""
        if self.use_flow_for_weights:
            return compute_flow_mask(flow)
        return self._grabcut_cached(int(ids[0]))

    def _grabcut_cached(self, frame_idx: int) -> np.ndarray:
        """grabCut is ~100ms of CPU per frame and deterministic — cache per
        frame index so the hot loader path segments each start frame once
        (not once per item per epoch, and not twice under fancy_aug)."""
        cache = getattr(self, "_gc_cache", None)
        if cache is None:
            cache = self._gc_cache = {}
        if frame_idx not in cache:
            if len(cache) > 4096:
                cache.clear()
            img = self._load_img(self.datadict["img_path"][frame_idx])
            cache[frame_idx] = compute_grabcut_mask(img)
        return cache[frame_idx]

    def _get_poke(self, ids, rng, **kw):
        flow = self._load_flow((ids[0], 0))
        mask = self._get_fg_mask(ids, flow) if self.filter_flow else None
        poke, centers = simulate_poke(
            flow, rng, self.n_pokes, self.poke_size,
            zero_poke=(ids[1] == -1), fix_n_pokes=self.fix_n_pokes,
            equal_poke_val=self.equal_poke_val,
            foreground_mask=mask,
        )
        return poke, centers

    def _get_transfer_img(self, ids, rng, **kw):
        vids = self.datadict["vid"]
        others = np.unique(vids[vids != vids[ids[0]]])
        v = rng.choice(others) if len(others) else vids[ids[0]]
        cand = np.flatnonzero(vids == v)
        idx = int(rng.choice(cand))
        img = self._load_img(self.datadict["img_path"][idx]).astype(np.float32)
        img = img / 255.0
        return img if self.normalize_01 else img * 2.0 - 1.0

    def _get_sampled_img(self, ids, rng, color: bool = False):
        """A random frame of the same video under fresh geometric (and
        optionally color) transforms — the appearance-disentanglement inputs
        (reference datakeys img_sT / app_img_dis, base_dataset.py:114-117)."""
        vids = self.datadict["vid"]
        cand = np.flatnonzero(vids == vids[ids[0]])
        idx = int(rng.choice(cand))
        img = self._load_img(self.datadict["img_path"][idx])
        if color and self.color_aug:
            ct = self.color_aug.sample(rng)
            img = ct(img)
        if self.geom_aug:
            gt = self.geom_aug.sample(rng)
            img = gt(img)
        img = img.astype(np.float32) / 255.0
        return img if self.normalize_01 else img * 2.0 - 1.0

    def _get_keypoints(self, ids, rng, abs=True, **kw):
        raise NotImplementedError(f"{type(self).__name__} has no keypoints")

    _get_keypoint_poke = _get_keypoints

    def _get_nn_index(self, ids, rng) -> int:
        """Start frame of the kinematics nearest neighbor.  Base fallback:
        a random frame from a different video (datasets without keypoint-NN
        metadata — the reference only supports `nn` on iPER,
        flow_dataset.py:511-562)."""
        vids = self.datadict["vid"]
        others = np.flatnonzero(vids != vids[ids[0]])
        if others.size == 0:
            others = np.arange(len(self))
        return int(rng.choice(others))

    # -- item assembly -----------------------------------------------------------
    def get_item(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        ids = self._get_valid_ids(index, rng)
        color_t = self.color_aug.sample(rng) if self.color_aug else None
        geom_t = self.geom_aug.sample(rng) if self.geom_aug else None

        for trial in range(self.max_trials_flow_load):
            try:
                out = {}
                for key in self.datakeys:
                    if key == "images":
                        out[key] = self._get_imgs(ids, rng, color_t, geom_t)
                    elif key == "poke":
                        poke, centers = self._get_poke(ids, rng)
                        out["poke"] = poke
                        out["poke_coords"] = centers
                    elif key == "flow":
                        out[key] = self._get_flow(ids, rng, geom_t)
                    elif key == "original_flow":
                        out[key] = self._get_flow(ids, rng, geom_t,
                                                  always_original=True)
                    elif key == "sample_ids":
                        out[key] = np.asarray(
                            [ids[0]] + [ids[0] + i * self.subsample_step
                                        for i in range(1, self.max_frames + 1)],
                            np.int64,
                        )
                    elif key in ("app_img_random", "app_img_cmp"):
                        out[key] = self._get_transfer_img(ids, rng)
                    elif key == "img_aT":
                        # fresh color transform on this clip's frames
                        # (reference base_dataset.py:113 — appearance aug;
                        # fancy_aug adds fg/bg-separated color transforms)
                        ct = (self.color_aug.sample(rng)
                              if self.color_aug else None)
                        out[key] = self._get_imgs(ids, rng, ct, None,
                                                  fb_aug=self.fancy_aug)
                    elif key in ("img_sT", "app_img_dis"):
                        # random same-video frame under fresh transforms
                        out[key] = self._get_sampled_img(
                            ids, rng, color=(key == "app_img_dis"))
                    elif key == "keypoints_abs":
                        out[key] = self._get_keypoints(ids, rng, abs=True)
                    elif key == "keypoints_rel":
                        out[key] = self._get_keypoints(ids, rng, abs=False)
                    elif key == "keypoint_poke":
                        kp_poke, kp_centers, kp_ids = \
                            self._get_keypoint_poke(ids, rng)
                        out[key] = kp_poke
                        out["keypoint_poke_coords"] = kp_centers
                        out["keypoint_poke_ids"] = kp_ids
                    elif key == "nn":
                        # kinematics-NN clip payload (reference _get_nn,
                        # flow_dataset.py:511-562 returns imgs+flow+ids of
                        # the retrieved neighbor)
                        nn_ids = (self._get_nn_index(ids, rng), ids[1])
                        out["nn_images"] = self._get_imgs(nn_ids, rng,
                                                          color_t, geom_t)
                        out["nn_flow"] = self._get_flow(nn_ids, rng, geom_t)
                        out["nn_sample_ids"] = np.asarray(
                            [nn_ids[0]] +
                            [nn_ids[0] + i * self.subsample_step
                             for i in range(1, self.max_frames + 1)])
                return out
            except FlowError:
                ids = (int(rng.integers(0, len(self))), ids[1])
        raise IOError(
            f"flow loading failed {self.max_trials_flow_load} times in a row"
        )


class PlantDataset(VideoDataset):
    """Poking Plants (reference flow_dataset.py:22-320): flow_cutoff 0.4,
    temporal subsample 2, object weighting (inverse per-object frequency,
    normalized — reference ``:188-195``)."""

    subsample_step = 2
    flow_cutoff = 0.4
    obj_weighting = True
    default_lag = 1  # reference :207 (pre lag-reset)

    def _set_instance_specific_values(self):
        if "object_id" in self.datadict and "weights" not in self.datadict:
            obj = self.datadict["object_id"]
            _, counts = np.unique(obj, return_counts=True)
            freq = {o: c for o, c in zip(*np.unique(obj, return_counts=True))}
            w = np.asarray([1.0 / freq[o] for o in obj], np.float64)
            self.datadict["weights"] = w / w.sum()


class IperDataset(VideoDataset):
    """iPER (reference flow_dataset.py:372-562): official ``train.txt``
    split, grabCut poke filtering (flow_cutoff 0.6), keypoint metadata when
    available (run the ``pose_estimation`` prep)."""

    subsample_step = 1
    flow_cutoff = 0.6
    filter_flow_default = True
    use_flow_for_weights = False  # grabCut mask (reference :398)
    default_lag = 0

    # reference :382-390 — bone segments over the pose-net keypoint layout
    bone_ids = {
        "r_upperarm": (11, 12), "r_forearm": (10, 11),
        "l_upperam": (13, 14), "l_forearm": (14, 15), "spine": (6, 7),
        "l_thigh": (1, 2), "r_thigh": (3, 4), "r_lowerleg": (0, 1),
        "l_lowerleg": (4, 5),
    }

    def _make_split(self, dd):
        """``split: official`` -> the published ``train.txt`` video names
        (reference :430-450); per-key 80/20 otherwise."""
        if self.split == "official":
            train_txt = None
            if self.data_root is not None:
                cand = os.path.join(self.data_root, "train.txt")
                if os.path.exists(cand):
                    train_txt = cand
            if train_txt is not None:
                with open(train_txt) as f:
                    names = [n.replace("/", "_").rstrip() for n in f
                             if n.strip()]
                paths = dd["img_path"].astype(str)
                train_idx = np.asarray([], dtype=np.int64)
                for n in names:
                    train_idx = np.append(
                        train_idx, np.flatnonzero(np.char.find(paths, n) != -1))
                train_idx = np.sort(np.unique(train_idx))
                if self.train:
                    return train_idx
                return np.flatnonzero(np.logical_not(np.isin(
                    np.arange(paths.shape[0]), train_idx)))
            return super()._make_split(dd)  # 'train' flag fallback
        key = {"videos": "vid", "objects": "object_id",
               "actions": "action_id", "actors": "actor_id"}.get(
            self.split, "vid")
        return self._split_per_group(dd, key)

    def _set_instance_specific_values(self):
        self.keypoints = self.datadict.get("keypoints")
        # meta['kp_nn'] from prep indexes the FULL pre-split frame list; the
        # datadict arrays here are split-subset, so those global ids would
        # dereference the wrong frames (or overflow).  The reference computes
        # the kinematics NN per split dataset (flow_dataset.py:790-808) —
        # mirror that from the split-local keypoints, EAGERLY at init when
        # the nn datakey is requested (the loader's thread pool must never
        # race to compute it on the hot path).
        self.kp_nn = None
        if self.keypoints is not None and "nn" in self.datakeys:
            from ..eval.pose import keypoint_nearest_neighbors

            self.kp_nn = keypoint_nearest_neighbors(
                np.asarray(self.keypoints, np.float32),
                np.asarray(self.datadict["vid"]))

    def _get_keypoints(self, ids, rng, abs=True, **kw):
        if self.keypoints is None:
            raise NotImplementedError(
                "meta has no keypoints (run ipoke_tpu_torch.data.prep's pose_estimation)")
        frame_ids = [
            min(ids[0] + i * self.subsample_step, int(self.seq_end_id[ids[0]]))
            for i in range(self.max_frames + 1)
        ]
        kps = self.keypoints[frame_ids].astype(np.float32)
        if not abs:
            kps = kps / np.asarray(self.spatial_size, np.float32)
        return kps

    def _get_keypoint_poke(self, ids, rng, **kw):
        """Poke at an annotated keypoint with the keypoint's displacement
        over the clip as value (reference base_dataset.py:460-495)."""
        kps = self._get_keypoints(ids, rng, abs=True)
        kp0, kpT = kps[0], kps[-1]
        disp = kpT - kp0
        mag = np.linalg.norm(disp, axis=-1)
        cand = np.flatnonzero(mag > np.median(mag))
        if cand.size == 0:
            cand = np.arange(kp0.shape[0])
        k = int(rng.choice(cand))
        poke = np.zeros((*self.spatial_size, 2), np.float32)
        x, y = kp0[k]
        r, c = int(np.clip(y, 0, self.spatial_size[0] - 1)), int(
            np.clip(x, 0, self.spatial_size[1] - 1))
        half = self.poke_size // 2
        poke[max(0, r - half): r + half + 1,
             max(0, c - half): c + half + 1] = disp[k][::-1]  # (dy, dx)
        centers = np.full((self.n_pokes, 2), -1, np.int32)
        centers[0] = (r, c)
        return poke, centers, np.asarray([k], np.int32)

    def _get_nn_index(self, ids, rng) -> int:
        """Keypoint-NN retrieval (reference flow_dataset.py:513 ``nn_ids``,
        computed per split :790-808); random-other-video fallback when pose
        prep hasn't run.  Normally precomputed at init; the lazy path (a
        caller appended 'nn' to datakeys post-construction, e.g. --test
        transfer) is serialized so loader threads can't duplicate the
        computation."""
        if self.keypoints is None:
            return super()._get_nn_index(ids, rng)
        if self.kp_nn is None:
            from ..eval.pose import keypoint_nearest_neighbors

            lock = self.__dict__.setdefault("_nn_lock", threading.Lock())
            with lock:
                if self.kp_nn is None:
                            self.kp_nn = keypoint_nearest_neighbors(
                        np.asarray(self.keypoints, np.float32),
                        np.asarray(self.datadict["vid"]))
        return int(self.kp_nn[ids[0]])


class TaichiDataset(VideoDataset):
    """TaiChi-HD (reference flow_dataset.py:354-371): grabCut-filtered pokes
    (flow_cutoff 0.1), subsample 2, flag split, no object weighting."""

    subsample_step = 2
    flow_cutoff = 0.1
    filter_flow_default = True
    use_flow_for_weights = False
    default_lag = 1


class Human36mDataset(VideoDataset):
    """Human3.6m (reference flow_dataset.py:564-604): official actor split
    (subjects 9/11 = test, encoded as the meta ``train`` flag by
    data/human36m_preprocess.py), lanczos resize, flow-magnitude masks."""

    subsample_step = 2
    flow_cutoff = 0.3
    use_flow_for_weights = True
    use_lanczos = True
    default_lag = 1

    def _make_split(self, dd):
        if self.split == "gui":  # reference :605-620
            return self._split_per_group(dd, "vid")
        return super()._make_split(dd)  # 'official' = actor train flag

    def _select_lag(self):
        """Reference :124-127: h36m flows are stored per subsample step —
        lag 0 for subsample 1, lag 1 for subsample 2."""
        n_cols = self.datadict["flow_paths"].shape[1]
        self.valid_lags = [min(0 if self.subsample_step == 1 else 1,
                               n_cols - 1)]


class VegetationDataset(PlantDataset):
    """Reference flow_dataset.py:323-351: flag split, no poke filtering,
    flow_cutoff 0.3."""

    flow_cutoff = 0.3
    filter_flow_default = False
    default_lag = 0


__datasets__ = {
    "PlantDataset": PlantDataset,
    "IperDataset": IperDataset,
    "TaichiDataset": TaichiDataset,
    "Human36mDataset": Human36mDataset,
    "VegetationDataset": VegetationDataset,
}


def get_dataset(name: str):
    return __datasets__[name]
