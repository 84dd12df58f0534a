"""Batch evaluation (the counterpart of ``testing_eval_models.py``): every
model named in a text file through the requested ``--test`` modes of
``python -m ipoke_tpu_torch.main``, one process each.

    python -m ipoke_tpu_torch.scripts.testing_eval_models \
        --models config/model_names.txt --config config/second_stage.yaml \
        --tests fvd accuracy diversity --data_root $DATA [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def commands(names, config: str, tests, data_root=None, device: str = "cuda"):
    """The command line of each (model, mode), in order."""
    out = []
    for name in names:
        for mode in tests:
            cmd = [sys.executable, "-m", "ipoke_tpu_torch.main", "--config", config,
                   "--model_name", name, "--test", mode, "--device", device]
            if data_root:
                cmd += ["--data_root", data_root]
            out.append((name, mode, cmd))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", required=True, help="text file with one model name per line")
    p.add_argument("--config", required=True)
    p.add_argument("--tests", nargs="+", default=["fvd", "accuracy", "diversity", "kps_acc"])
    p.add_argument("--data_root", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    with open(args.models) as f:
        names = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    failures = []
    for name, mode, cmd in commands(names, args.config, args.tests, args.data_root,
                                    args.device):
        print(f"== {name} / {mode} ==", flush=True)
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            failures.append((name, mode, rc))
    if failures:
        print("FAILURES:", failures)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
