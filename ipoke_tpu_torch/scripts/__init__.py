"""The port's counterparts of the repo's FC root scripts, run with ``python -m
ipoke_tpu_torch.scripts.<name>`` (the JAX ones stay at the root):

* ``FlowAutoencoderFC``, ``ImgAutoencoderFC``, ``VidAutoencoderFC``,
  ``INN_FCAE``, ``INN_test`` and ``opticalFlowINN``: ``run`` over
  ``ipoke_tpu_torch.main.run`` with a default YAML each;
* ``FCAE_eval``: the angular and endpoint error of a trained flow
  encoder's reconstructions (``evaluate``);
* the conv side's: ``testing_eval_models`` (``--test`` modes per model,
  ``commands``), ``testing_evaluate_diversity`` (``evaluate``),
  ``data_analysis`` (``analyse``) and ``iper_loader_test`` (``sweep``);
* ``train_motion_feat``: MotionFeatureNet's pretext training (``train``).
"""

from __future__ import annotations

import argparse


def run(default_experiment: str, default_config: str, argv=None) -> int:
    """Train ``-c/--config`` (``default_config``, which runs
    ``default_experiment``) through ``ipoke_tpu_torch.main.run`` under
    ``--model_name`` (fcae), with ``--data_root``, ``--debug`` and
    ``--device`` (cuda) passed on."""
    from ipoke_tpu_torch import main
    from ipoke_tpu_torch.core.config import load_config

    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", default=default_config)
    p.add_argument("--model_name", default="fcae")
    p.add_argument("--data_root", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    if a.config == default_config:
        name = load_config(a.config).get_path("general.experiment")
        if str(name).lower() != default_experiment:
            raise ValueError(f"{default_config} runs {name}, not {default_experiment}")
    args = ["--config", a.config, "--model_name", a.model_name, "--device", a.device]
    if a.data_root:
        args += ["--data_root", a.data_root]
    if a.debug:
        args += ["--debug"]
    main.run(args)
    return 0
