"""Convert runs of the JAX package (orbax checkpoints) into the PyTorch
port's layout (``torch.save`` states), so that ``python -m
ipoke_tpu_torch.main --resume`` continues them and ``--test`` reads them.

    python tools/jax_run_to_torch.py --src <JAX base dir> --dst <port base dir> \
        [--experiment second_stage] [--model_name NAME]

Every version under ``<src>/<experiment>/ckpt/<model>/`` is converted: the
states of ``last`` and of the monitored checkpoints with their
``*_weights`` sidecars, ``best_k_models.yaml`` (its paths moved to
``--dst``), and the ``config``, ``log`` and ``generated`` directories (every
path under ``--src`` in a config moved to ``--dst``, so that a second
stage's frozen runs are the converted ones; convert those runs too).

The conv pipeline's experiments are converted: ``img_encoder``,
``poke_encoder``, ``first_stage`` and ``second_stage``.  The leaves go from
the JAX trees into the port's modules by ``ipoke_tpu_torch.convert``
(``load_flax`` with the spectral norms' ``u`` and ``sigma``,
``load_image_ae``, ``second_stage_params``), each state's ``step`` with
them.  The optimizer state does not come across: each converted state
holds ``tx: None``, and the port's experiment starts a fresh optimizer
(moments and its lr schedule's count at 0) where it restores one; the tool
says so for every run.  It imports both packages, as the tests do.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONVERTED = ("img_encoder", "poke_encoder", "first_stage", "second_stage")
FRESH = "optimizer state not converted: the port starts a fresh optimizer on --resume"


def read_orbax(path: str):
    """The tree of an orbax checkpoint directory as nested dicts and lists
    of numpy arrays."""
    import orbax.checkpoint as ocp

    from ipoke_tpu_torch.convert import to_numpy_tree

    return to_numpy_tree(ocp.StandardCheckpointer().restore(os.path.abspath(path)))


def build_nets(experiment: str, config):
    """The port's trained nets of ``experiment`` for ``config``, on the CPU."""
    from ipoke_tpu_torch.core.config import Config
    from ipoke_tpu_torch.models import first_stage as fs
    from ipoke_tpu_torch.models.image_ae import build_image_ae, build_image_disc

    config = Config(config)
    with torch.device("meta"):
        if experiment == "first_stage":
            nets = fs.build_first_stage(config)
        elif experiment in ("img_encoder", "poke_encoder"):
            nets = (build_image_ae(config), build_image_disc(config))
        else:
            raise ValueError(experiment)
    return tuple(n.to_empty(device="cpu") for n in nets)  # every tensor is loaded


def convert_tree(experiment: str, config, tree, weights: bool):
    """The port's checkpoint state (``weights``: its ``*_weights`` sidecar)
    of one JAX state tree of ``experiment``."""
    from ipoke_tpu_torch.convert import load_flax, load_image_ae, second_stage_params
    from ipoke_tpu_torch.flows import ParamTree

    if experiment == "second_stage":
        flow = ParamTree(second_stage_params(tree["params"])).state_dict()
        return flow if weights else {"flow": flow, "tx": None,
                                     "step": int(tree["step"])}
    if experiment == "first_stage":
        model, disc_s, disc_t = build_nets(experiment, config)
        if weights:
            load_flax(model, tree["params"], tree["stats"])
            return model.state_dict()
        load_flax(model, tree["params_g"], tree["stats_g"])
        load_flax(disc_s, tree["params_ds"], tree["stats_ds"])
        load_flax(disc_t, tree["params_dt"], tree["stats_dt"])
        return {"model": model.state_dict(), "disc_s": disc_s.state_dict(),
                "disc_t": disc_t.state_dict(), "tx": None, "step": int(tree["step"])}
    model, disc = build_nets(experiment, config)
    if weights:
        load_flax(model.ae, tree["params"], tree["stats"])
        return model.ae.state_dict()
    use_disc = experiment == "img_encoder"
    load_image_ae(model, tree["params"], tree["stats"],
                  disc if use_disc else None, tree.get("params_d"), tree.get("stats_d"))
    state = {"model": model.state_dict(), "tx": None, "step": int(tree["step"])}
    if use_disc:
        state.update(disc=disc.state_dict(), tx_d=None)
    return state


def _moved(node, src: str, dst: str):
    """``node`` with every string under ``src`` moved under ``dst``."""
    if isinstance(node, dict):
        return {k: _moved(v, src, dst) for k, v in node.items()}
    if isinstance(node, list):
        return [_moved(v, src, dst) for v in node]
    if isinstance(node, str) and (node == src or node.startswith(src + os.sep)):
        return dst + node[len(src):]
    return node


def convert_version(src: str, dst: str, experiment: str, model_name: str,
                    version: str, log=print) -> None:
    """One version of one run: its checkpoints, manifest and config."""
    from ipoke_tpu_torch.core.checkpoint import CheckpointStore

    with open(os.path.join(src, experiment, "config", model_name, f"{version}.yaml")) as f:
        config = yaml.safe_load(f)
    kind = str(config.get("general", {}).get("experiment", experiment)).lower()
    if kind not in CONVERTED:
        raise NotImplementedError(f"{experiment}/{model_name}: the {kind!r} runs are not "
                                  f"converted (only {', '.join(CONVERTED)})")
    vsrc = os.path.join(src, experiment, "ckpt", model_name, version)
    vdst = os.path.join(dst, experiment, "ckpt", model_name, version)
    os.makedirs(vdst, exist_ok=True)
    for name in sorted(os.listdir(vsrc)):
        path = os.path.join(vsrc, name)
        if not os.path.isdir(path):
            continue
        state = convert_tree(kind, config, read_orbax(path), name.endswith("_weights"))
        CheckpointStore._save_one(os.path.join(vdst, name), state)
        log(f"{experiment}/{model_name}/{version}/{name}: converted")
    manifest = os.path.join(vsrc, "best_k_models.yaml")
    if os.path.exists(manifest):
        with open(manifest) as f:
            entries = yaml.safe_load(f) or {}
        with open(os.path.join(vdst, "best_k_models.yaml"), "w") as f:
            yaml.safe_dump({_moved(os.path.abspath(k), src, dst)
                            if os.path.isabs(k) else k: v for k, v in entries.items()}, f)
    cfg_dst = os.path.join(dst, experiment, "config", model_name)
    os.makedirs(cfg_dst, exist_ok=True)
    with open(os.path.join(cfg_dst, f"{version}.yaml"), "w") as f:
        yaml.safe_dump(_moved(config, src, dst), f, sort_keys=False)
    log(f"{experiment}/{model_name}/{version}: {FRESH}")


def convert_runs(src: str, dst: str, experiment=None, model_name=None, log=print) -> int:
    """Every run under ``src`` (or the one named) into ``dst``; returns the
    number of versions converted."""
    src, dst = os.path.abspath(src), os.path.abspath(dst)
    n = 0
    for exp in sorted(os.listdir(src)):
        if experiment and exp != experiment:
            continue
        ckpt = os.path.join(src, exp, "ckpt")
        if not os.path.isdir(ckpt):
            continue
        for name in sorted(os.listdir(ckpt)):
            if model_name and name != model_name:
                continue
            for version in sorted(os.listdir(os.path.join(ckpt, name))):
                if version.isdigit():
                    convert_version(src, dst, exp, name, version, log)
                    n += 1
            for sub in ("log", "generated"):
                d = os.path.join(src, exp, sub, name)
                if os.path.isdir(d):
                    shutil.copytree(d, os.path.join(dst, exp, sub, name),
                                    dirs_exist_ok=True)
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True, help="the JAX package's base dir")
    p.add_argument("--dst", required=True, help="the port's base dir")
    p.add_argument("--experiment", default=None)
    p.add_argument("--model_name", default=None)
    args = p.parse_args(argv)
    n = convert_runs(args.src, args.dst, args.experiment, args.model_name)
    print(f"converted {n} run versions into {args.dst}")
    return 0 if n else 1


if __name__ == "__main__":
    raise SystemExit(main())
