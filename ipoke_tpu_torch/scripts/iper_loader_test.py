"""Sweep of the port's datamodule (the counterpart of
``iper_loader_test.py``): ``--n_batches`` train batches of a processed
dataset, the flow magnitudes' mean and 99th percentile and the samples
whose poke is zero.

    python -m ipoke_tpu_torch.scripts.iper_loader_test --data_root DIR \
        [--dataset IperDataset] [--spatial_size 64] [--n_batches 10]
"""

from __future__ import annotations

import argparse

import numpy as np


def sweep(data_root: str, dataset: str = "IperDataset", spatial_size: int = 64,
          n_batches: int = 10) -> dict:
    from ..data import StaticDataModule

    cfg = {"dataset": dataset, "spatial_size": (spatial_size, spatial_size),
           "max_frames": 10, "batch_size": 4, "n_workers": 4, "poke_size": 5,
           "n_pokes": 5, "zero_poke": True, "zero_poke_amount": 12,
           "yield_videos": True, "scale_poke_to_res": True}
    dm = StaticDataModule(cfg, ["images", "poke", "flow"], data_root=data_root)
    mags, n_zero = [], 0
    for batch in dm.train_loader(n_batches=n_batches):
        m = np.linalg.norm(batch["flow"], axis=-1)
        mags.append(m)
        n_zero += int((m.reshape(m.shape[0], -1).max(-1) == 0).sum())
    mags = np.concatenate(mags)
    return {"mean": float(mags.mean()), "p99": float(np.percentile(mags, 99)),
            "zero_poke_samples": n_zero}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", required=True)
    p.add_argument("--dataset", default="IperDataset")
    p.add_argument("--spatial_size", type=int, default=64)
    p.add_argument("--n_batches", type=int, default=10)
    a = p.parse_args(argv)
    s = sweep(a.data_root, a.dataset, a.spatial_size, a.n_batches)
    print(f"flow magnitude: mean={s['mean']:.3f} p99={s['p99']:.3f}; "
          f"zero-poke samples: {s['zero_poke_samples']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
