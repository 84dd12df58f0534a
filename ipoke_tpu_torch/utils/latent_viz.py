"""Latent-space scatter diagnostics and the per-frame metric errorbars
(counterpart of ``ipoke_tpu/utils/latent_viz.py``; reference ``log_umap``,
second_stage_video.py:599-638, and the per-frame metric dumps).

The projection is the JAX package's PCA (SVD), the basis fit on the first
entry and shared so that the clouds are comparable.  The scatter is drawn
with cv2 (matplotlib is not a dependency of the port): one colour per entry,
a legend in the corner, a 600x600 PNG.  ``plot_metric_errorbars`` draws one
panel per metric with ``utils.plots.draw_series`` and writes the JAX
package's CSV.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_COLOURS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40))  # RGB


def pca_2d(x: np.ndarray, basis: np.ndarray = None):
    """Project (N, D) onto the top-2 principal components."""
    x = x.reshape(x.shape[0], -1).astype(np.float64)
    mean = x.mean(0)
    if basis is None:
        _, _, vt = np.linalg.svd(x - mean, full_matrices=False)
        basis = vt[:2]
    return (x - mean) @ basis.T, basis


def plot_latent_scatter(latents: Dict[str, np.ndarray], path: str,
                        size: int = 600) -> str:
    """latents: name -> (N, ...) arrays; writes a PCA scatter PNG."""
    import cv2

    basis, projs = None, []
    for name, arr in latents.items():
        proj, basis = pca_2d(np.asarray(arr, np.float64), basis)
        projs.append((name, proj))
    pts = np.concatenate([p for _, p in projs])
    lo, hi = pts.min(0), pts.max(0)
    scale = (size - 40) / np.maximum(hi - lo, 1e-12)
    img = np.full((size, size, 3), 255, np.uint8)
    for i, (name, proj) in enumerate(projs):
        colour = _COLOURS[i % len(_COLOURS)][::-1]  # BGR
        xy = ((proj - lo) * scale + 20).astype(np.int64)
        for x, y in xy:
            cv2.circle(img, (int(x), int(size - 1 - y)), 2, colour, -1)
        cv2.putText(img, name, (10, 20 + 18 * i), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, colour, 1)
    cv2.putText(img, "latent space (PCA)", (size // 2 - 80, size - 8),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    if not cv2.imwrite(path, img):
        raise OSError(f"could not write {path}")
    return path


def plot_metric_errorbars(per_frame: Dict[str, np.ndarray], path: str,
                          csv_path: str = None) -> str:
    """Per-frame mean +- std of each metric (name -> (N, T) array): one panel
    a metric side by side in a PNG, and the CSV ``metric,frame,mean,std``."""
    from .plots import draw_series, save_figure

    panels, rows = [], []
    for name, arr in per_frame.items():
        arr = np.asarray(arr)
        mean, std = arr.mean(0), arr.std(0)
        frames = np.arange(1, arr.shape[1] + 1)
        panels.append(draw_series([(name, frames, mean, std)], "frame", name,
                                  title=name, size=(400, 320)))
        rows.append((name, mean, std))
    save_figure(path, np.concatenate(panels, axis=1))
    if csv_path:
        with open(csv_path, "w") as f:
            f.write("metric,frame,mean,std\n")
            for name, mean, std in rows:
                for t, (m, s) in enumerate(zip(mean, std)):
                    f.write(f"{name},{t + 1},{m:.6f},{s:.6f}\n")
    return path
