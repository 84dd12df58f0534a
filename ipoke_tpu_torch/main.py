"""The port's CLI entry point (counterpart of the repo's ``main.py``, which
stays the JAX package's):

    python -m ipoke_tpu_torch.main --config config/<stage>.yaml
        --model_name <name> [--resume] [--last_ckpt] [--target_version N]
        [--data_root PATH] [--debug] [--device cuda|cpu]

Trains ``img_encoder``, ``poke_encoder``, ``first_stage``, ``second_stage``,
``flow_vae`` and ``flow_motion``, and the FC tower's ``flow_encoder_fc``,
``img_encoder_fc``, ``poke_encoder_FC``, ``first_stage_fc``, ``inn_fcae``,
``second_stage_fc`` and the FC third stage ``third_stage_fc``, from the
shipped YAMLs, with ``main.py``'s
flags and run-directory layout (``$DATAPATH_BASE`` or ``general.base_dir``;
the dataset from ``--data_root``, ``data.data_root`` or ``$DATAPATH``).
``--test <mode>`` evaluates the run's latest version instead
(``cli.testing.run_test``: samples, fvd, accuracy, diversity,
control_sensitivity, transfer, kps_acc on a second stage, conv or FC;
realism and the third stage's accuracy on a ``third_stage_fc`` run).  TF32 is off
for the run.  ``--device`` defaults to
``cuda`` and raises without a card: only ``--device cpu`` runs on the CPU.
``--devices`` above 1 raises rather than be ignored, as the JAX CLI does
(sharded training: ``ipoke_tpu_torch.parallel``);
``--gpus`` is accepted and ignored, as in ``main.py``.
"""

import argparse
import os
import sys

TEST_MODES = ["none", "fvd", "accuracy", "samples", "diversity", "kps_acc",
              "transfer", "control_sensitivity", "realism"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ipoke_tpu_torch trainer")
    p.add_argument("--config", required=True)
    p.add_argument("--model_name", required=True)
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices (only 1 is ported)")
    p.add_argument("--gpus", type=str, default=None,
                   help="accepted for reference-CLI compatibility; ignored")
    p.add_argument("--test", default="none", choices=TEST_MODES)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--last_ckpt", action="store_true")
    p.add_argument("--target_version", type=int, default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_parameters(args):
    from ipoke_tpu_torch.core.checkpoint import create_dir_structure
    from ipoke_tpu_torch.core.config import load_config

    config = load_config(args.config)
    gen = config["general"]
    gen["model_name"] = args.model_name
    gen["test"] = args.test
    gen["resume"] = args.resume
    gen["last_ckpt"] = args.last_ckpt
    if args.debug:
        gen["debug"] = True
    if args.target_version is not None:
        gen["target_version"] = args.target_version
    base_dir = os.environ.get("DATAPATH_BASE", gen.get("base_dir", "logs"))
    dirs = create_dir_structure(base_dir, gen["experiment"], args.model_name)
    data_root = (args.data_root or config.get_path("data.data_root")
                 or os.environ.get("DATAPATH"))
    return config, dirs, data_root


def maybe_prompt_resume(config, dirs):
    """Interactive resume-on-name-collision prompt (reference main.py:39-55),
    gated on a TTY so headless runs never block on input()."""
    from ipoke_tpu_torch.core.checkpoint import latest_version

    gen = config["general"]
    if (gen.get("test", "none") != "none" or gen.get("resume")
            or gen.get("debug") or gen.get("target_version") is not None):
        return
    if latest_version(dirs["ckpt"]) is None:
        return
    if not (sys.stdin.isatty() and sys.stdout.isatty()):
        return
    print("WARNING: model has been started somewhen earlier: "
          "resume training (y/n)?")
    while True:
        answer = input().strip().lower()
        if answer in ("y", "yes"):
            gen["resume"] = True
            return
        if answer in ("n", "no"):
            return
        print("Invalid answer! Try again! (y/n)")


def check_device(device) -> None:
    """Raise when ``device`` is the card and there is none: no entry point
    of the port falls back to the CPU."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")


def check_args(args):
    """Raise for what the port does not run (before any file is written)."""
    if args.devices is not None and args.devices > 1:
        raise NotImplementedError(
            "--devices > 1: the JAX CLI stores --devices and shards nothing "
            "either; sharded second-stage training runs through "
            "ipoke_tpu_torch.parallel (make_mesh, SecondStageTrainer(mesh=...), "
            "python -m ipoke_tpu_torch.parallel.dryrun)")
    check_device(args.device)


def run(argv=None):
    """Train as ``main`` does and return the finished experiment; under
    ``--test`` run the mode and return its metrics."""
    args = parse_args(argv)
    check_args(args)
    import torch

    # fp32 matmuls and convolutions without TF32: the precision every
    # measurement and parity tolerance of the port assumes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ipoke_tpu_torch.cli.experiments import select_experiment
    from ipoke_tpu_torch.core.config import load_config

    cls = select_experiment(load_config(args.config))  # raises if not ported
    config, dirs, data_root = load_parameters(args)
    maybe_prompt_resume(config, dirs)
    experiment = cls(config, dirs, data_root=data_root, device=args.device)
    if args.test == "none":
        return experiment.train()
    from ipoke_tpu_torch.cli.testing import run_test

    try:
        return run_test(experiment, args.test)
    finally:
        experiment.metrics_logger.close()


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
