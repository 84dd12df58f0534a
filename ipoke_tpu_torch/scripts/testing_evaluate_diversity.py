"""Diversity scores of saved samples (the counterpart of
``testing_evaluate_diversity.py``): the ``samples_batch*.npy`` dumps (B, S,
T, H, W, 3) of a ``--test samples`` run, their pairwise MSE and VGG cosine
diversity (``eval/metrics.py``; VGG19 from ``IPOKE_VGG_WEIGHTS``, else
fixed-seed, ``entry.build_vgg``).

    python -m ipoke_tpu_torch.scripts.testing_evaluate_diversity \
        --samples_dir logs/second_stage/generated/<model>/samples [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def evaluate(samples_dir: str, max_batches: int = 10, device="cuda") -> dict:
    from ..entry import build_vgg
    from ..eval.metrics import diversity_score_mse, diversity_score_vgg

    files = sorted(glob.glob(os.path.join(samples_dir, "samples_batch*.npy")))
    assert files, f"no samples_batch*.npy in {samples_dir}"
    samples = np.concatenate([np.load(f) for f in files[:max_batches]], axis=0)
    return {"divscore_mse": diversity_score_mse(samples),
            "divscore_vgg": diversity_score_vgg(build_vgg(device), samples),
            "n_datapoints": int(samples.shape[0]),
            "n_samples_per_point": int(samples.shape[1])}


def main(argv=None) -> int:
    from ..main import check_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--samples_dir", required=True)
    p.add_argument("--max_batches", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    check_device(args.device)
    print(json.dumps(evaluate(args.samples_dir, args.max_batches, args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
