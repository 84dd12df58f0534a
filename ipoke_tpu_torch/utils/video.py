"""Video and flow visualisation and export (a numpy + cv2 copy of
``ipoke_tpu/utils/video.py``; reference ``utils/logging.py``): the grid
builders and mp4 writers of the ``--test`` modes' artifacts, and flow
colourisation for inspecting pokes.  Inputs are host arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((video + 1.0) * 127.5, 0, 255).astype(np.uint8)


def flow_to_rgb(flow: np.ndarray, max_mag: Optional[float] = None) -> np.ndarray:
    """HSV flow colorization (reference ``utils/logging.py`` vis_flow)."""
    import cv2

    mag = np.linalg.norm(flow, axis=-1)
    ang = np.arctan2(flow[..., 1], flow[..., 0])
    max_mag = max_mag or max(mag.max(), 1e-6)
    hsv = np.zeros((*flow.shape[:-1], 3), np.uint8)
    hsv[..., 0] = ((ang + np.pi) / (2 * np.pi) * 180).astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = np.clip(mag / max_mag * 255, 0, 255).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def make_grid(frames: np.ndarray, n_per_row: int) -> np.ndarray:
    """(N, H, W, 3) -> one tiled image."""
    n, h, w, c = frames.shape
    rows = -(-n // n_per_row)
    pad = rows * n_per_row - n
    if pad:
        frames = np.concatenate(
            [frames, np.zeros((pad, h, w, c), frames.dtype)])
    return (frames.reshape(rows, n_per_row, h, w, c)
            .transpose(0, 2, 1, 3, 4).reshape(rows * h, n_per_row * w, c))


def save_video(video: np.ndarray, path: str, fps: int = 3):
    """(T, H, W, 3) float [-1,1] or uint8 -> mp4 (cv2 VideoWriter, reference
    ``utils/logging.py:797``)."""
    import cv2

    if video.dtype != np.uint8:
        video = to_uint8(video)
    t, h, w, _ = video.shape
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame in video:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def save_video_grid(videos: np.ndarray, path: str, fps: int = 3):
    """(B, S, T, H, W, 3) -> one mp4, B rows x S columns."""
    b, s, t, h, w, c = videos.shape
    frames = []
    for ti in range(t):
        frame = videos[:, :, ti].reshape(b * s, h, w, c)
        frames.append(make_grid(frame, n_per_row=s))
    save_video(np.stack(frames), path, fps=fps)


def draw_poke_arrows(img: np.ndarray, poke: np.ndarray,
                     color=(255, 0, 0)) -> np.ndarray:
    """Overlay arrows at poke locations pointing along the poke vectors
    (reference ``make_poke_img``, utils/logging.py:121)."""
    import cv2

    out = img.copy() if img.dtype == np.uint8 else to_uint8(img)
    out = np.ascontiguousarray(out)  # cv2 rejects sliced/strided arrays
    mag = np.linalg.norm(poke, axis=-1)
    ys, xs = np.nonzero(mag > 0)
    seen = set()
    for y, x in zip(ys, xs):
        key = (y // 5, x // 5)  # one arrow per poke window
        if key in seen:
            continue
        seen.add(key)
        dx, dy = poke[y, x]
        tip = (int(np.clip(x + dx, 0, out.shape[1] - 1)),
               int(np.clip(y + dy, 0, out.shape[0] - 1)))
        cv2.arrowedLine(out, (int(x), int(y)), tip, color, 1, tipLength=0.3)
    return out


def make_flow_video_grid(x0, poke, samples, target, flow, path: str,
                         fps: int = 3):
    """Training-progress grid (reference ``make_flow_video_with_samples``,
    utils/logging.py:468): columns = [x0+poke arrows | flow vis | target |
    samples...], rows = batch items; animated over time."""
    b, t = target.shape[0], target.shape[1]
    x0_u8 = np.stack([draw_poke_arrows(x0[i], poke[i]) for i in range(b)])
    flow_u8 = np.stack([flow_to_rgb(flow[i]) for i in range(b)])
    cols = [np.repeat(x0_u8[:, None], t, 1), np.repeat(flow_u8[:, None], t, 1),
            to_uint8(target)]
    for s in samples:
        cols.append(to_uint8(np.asarray(s)))
    grid = np.stack(cols, axis=1)  # (B, n_cols, T, H, W, 3)
    save_video_grid(grid, path, fps=fps)
    return path


def save_enrollment(video: np.ndarray, path: str, max_frames: int = 10):
    """Horizontal strip of a video's frames (reference enrollment PNGs,
    utils/logging.py:758-823)."""
    import cv2

    v = to_uint8(video[:max_frames]) if video.dtype != np.uint8 \
        else video[:max_frames]
    strip = np.concatenate(list(v), axis=1)
    cv2.imwrite(path, strip[..., ::-1])
    return path


def make_multipoke_grid(x0, pokes, target, samples, path: str, fps: int = 3):
    """Per-element control-sensitivity grid (reference ``make_multipoke_grid``
    use in ``_control_sensitivity``, second_stage_video.py:875-900): one row
    per poke variant — [x0 with that poke's arrows | generated video] — with
    the ground-truth clip as the top row.

    x0 (H, W, 3); pokes (P, H, W, 2); target (T, H, W, 3);
    samples (P, T, H, W, 3).  Returns the list of per-poke videos so callers
    can save singles + enrollments like the reference."""
    p, t = samples.shape[0], samples.shape[1]
    rows = [np.stack([np.repeat(to_uint8(x0)[None], t, 0),
                      to_uint8(np.asarray(target[:t]))])]
    for k in range(p):
        poked = draw_poke_arrows(x0, np.asarray(pokes[k]))
        rows.append(np.stack([np.repeat(poked[None], t, 0),
                              to_uint8(np.asarray(samples[k]))]))
    save_video_grid(np.stack(rows), path, fps=fps)
    return [np.asarray(samples[k]) for k in range(p)]


def make_transfer_grid(src_videos, tgt_x0, transferred, path: str,
                       fps: int = 3, extra=None):
    """Kinematics-transfer grid (reference ``make_transfer_grids_new``,
    utils/logging.py:628): [source video | target x0 (static) | transfer |
    extra columns...] — e.g. the random-residual control video."""
    b, t = transferred.shape[0], transferred.shape[1]
    cols = [to_uint8(np.asarray(src_videos)),
            np.repeat(to_uint8(tgt_x0)[:, None], t, 1),
            to_uint8(np.asarray(transferred))]
    for e in (extra or []):
        cols.append(to_uint8(np.asarray(e)))
    save_video_grid(np.stack(cols, axis=1), path, fps=fps)
    return path
