"""The reconstruction error of a trained flow encoder (reference
``FCAE_eval.py:14-26``): the angular (5/10/15 degrees) and endpoint
(1/2/3/5 px) error categories of its posterior reconstructions of the test
flow maps, averaged over ``--n_batches`` batches, printed as JSON:

    python -m ipoke_tpu_torch.scripts.FCAE_eval --config <flow_encoder_fc yaml>
        --model_name NAME [--data_root PATH] [--n_batches 20] [--device cuda|cpu]
"""
import argparse
import json
from typing import Dict, Optional

import numpy as np


def evaluate(config: str, model_name: str, data_root: Optional[str] = None,
             n_batches: int = 20, device: str = "cuda") -> Dict[str, float]:
    """The run's best checkpoint (its latest version) restored, then the
    mean error categories over ``n_batches`` test batches."""
    import torch

    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch.cli.experiments import select_experiment
    from ipoke_tpu_torch.cli.testing import _restore_trained
    from ipoke_tpu_torch.eval import optical_flow_metrics

    argv = ["--config", config, "--model_name", model_name, "--test", "samples",
            "--device", device] + (["--data_root", data_root] if data_root else [])
    args = cli.parse_args(argv)
    cli.check_args(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, dirs, root = cli.load_parameters(args)
    exp = select_experiment(cfg)(cfg, dirs, data_root=root, device=device)
    try:
        _restore_trained(exp, require_sampler=False)
        agg = {}
        with torch.no_grad():
            for batch in exp.batches(exp.datamodule.test_loader(n_batches=n_batches)):
                x = batch["flow"]
                noise = torch.randn((x.shape[0], exp.model.z_dim), generator=exp.generator,
                                    device=x.device)
                for k, v in optical_flow_metrics(x, exp.model(x, noise)[0]).items():
                    agg.setdefault(k, []).append(float(v))
    finally:
        exp.metrics_logger.close()
    return {k: float(np.mean(v)) for k, v in agg.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--model_name", required=True)
    p.add_argument("--data_root", default=None)
    p.add_argument("--n_batches", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    print(json.dumps(evaluate(a.config, a.model_name, a.data_root, a.n_batches, a.device),
                     indent=2))


if __name__ == "__main__":
    main()
