"""Optical-flow statistics of a processed dataset (the counterpart of
``data_analysis.py``): the magnitudes of its ``*.flow.npy`` files, and
colourised previews of the first 16 (``utils/video.py::flow_to_rgb``).

    python -m ipoke_tpu_torch.scripts.data_analysis --processed_dir DIR \
        [--out_dir PREVIEWS] [--max_files 100]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def analyse(processed_dir: str, out_dir=None, max_files: int = 100) -> dict:
    """The magnitude statistics of the first ``max_files`` flows (sorted
    paths), and the previews written to ``out_dir``."""
    from ..utils.video import flow_to_rgb

    files = sorted(glob.glob(os.path.join(processed_dir, "**", "*.flow.npy"),
                             recursive=True))[:max_files]
    mags = np.stack([np.linalg.norm(np.load(f), axis=0) for f in files])
    stats = {"n_files": len(files), "mean": float(mags.mean()), "std": float(mags.std()),
             "p95": float(np.percentile(mags, 95)), "max": float(mags.max())}
    if out_dir:
        import cv2

        os.makedirs(out_dir, exist_ok=True)
        for f in files[:16]:
            rgb = flow_to_rgb(np.transpose(np.load(f), (1, 2, 0)))
            name = os.path.basename(os.path.dirname(f)) + "_" + \
                os.path.basename(f).replace(".flow.npy", ".png")
            cv2.imwrite(os.path.join(out_dir, name), rgb[..., ::-1])
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--processed_dir", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--max_files", type=int, default=100)
    a = p.parse_args(argv)
    s = analyse(a.processed_dir, a.out_dir, a.max_files)
    print(f"{s['n_files']} flow files; magnitude mean={s['mean']:.3f} "
          f"std={s['std']:.3f} p95={s['p95']:.3f} max={s['max']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
