"""Convert runs of the JAX package (orbax checkpoints) into the PyTorch
port's layout (``torch.save`` states), so that ``python -m
ipoke_tpu_torch.main --resume`` continues them, optimizer and all, and
``--test`` reads them.

    python tools/jax_run_to_torch.py --src <JAX base dir> --dst <port base dir> \
        [--experiment second_stage] [--model_name NAME]

Every version under ``<src>/<experiment>/ckpt/<model>/`` is converted: the
states of ``last`` and of the monitored checkpoints with their
``*_weights`` sidecars, ``best_k_models.yaml`` (its paths moved to
``--dst``), and the ``config``, ``log`` and ``generated`` directories (every
path under ``--src`` in a config moved to ``--dst``, so that a later
stage's frozen runs are the converted ones; convert those runs too).

Every experiment of the JAX registry is converted (``CONVERTED``).  For
each version the tool builds the port's own experiment on the CPU from the
run's config, its frozen nets drawn (only their shapes matter here), loads
the JAX leaves into its nets (``ipoke_tpu_torch.convert``: ``load_flax``
with the spectral norms' ``u`` and ``sigma``, ``load_image_ae``, the flow
trees by path) and the optax state into its optimizers
(``convert.optax_state_dict``: Adam, AMSGrad, Adafactor, AdaBelief, the fp32
masters and ``MultiSteps``' accumulator, with the update count that the lr
schedule reads), and saves what the experiment's own ``checkpoint_state``
gives, with the step.  A state it cannot map raises and names the leaf.
The flow VAE's JAX state keeps no spectral-norm stats (its experiment
holds them beside the state): they come from the sidecar saved with it.
It imports both packages, as the tests do.
"""

from __future__ import annotations

import argparse
import copy
import os
import shutil
import sys

import numpy as np
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX registry's experiments (ipoke_tpu/cli/experiments.py:_registry)
CONVERTED = ("img_encoder", "poke_encoder", "first_stage", "second_stage",
             "img_encoder_fc", "poke_encoder_fc", "first_stage_fc", "second_stage_fc",
             "flow_encoder_fc", "third_stage_fc", "flow_motion", "flow_vae", "inn_fcae")
# the frozen runs a config names; the converter draws them instead
FROZEN = ("first_stage", "conditioner", "poke_embedder", "flow_encoder", "second_stage",
          "flow_vae")
# the second stage's tree: the flow's alone unless the JAX params hold more
# (convert.second_stage_params)
_SECOND = lambda tree: tree if len(tree) > 1 else tree["flow"]
# the flow experiments: (the port's trainable tree, its part of the JAX
# params)
FLOWS = {"second_stage": (lambda e: e.model.flow_params, _SECOND),
         "second_stage_fc": (lambda e: e.model.flow_params, _SECOND),
         "inn_fcae": (lambda e: e.inn_params, lambda tree: tree),
         "third_stage_fc": (lambda e: e.model.inn_params, lambda tree: tree),
         "flow_motion": (lambda e: e.model.inn_params, lambda tree: tree["inn"])}


def read_orbax(path: str):
    """The tree of an orbax checkpoint directory as nested dicts and lists
    of numpy arrays."""
    import orbax.checkpoint as ocp

    from ipoke_tpu_torch.convert import to_numpy_tree

    return to_numpy_tree(ocp.StandardCheckpointer().restore(os.path.abspath(path)))


def port_experiment(kind: str, config):
    """The port's experiment of ``kind`` for ``config``, built on the CPU
    and brought to the form its ``--resume`` loads into
    (``_resume_template``), without a run dir, data or logger; the frozen
    runs its config names are drawn from the seed."""
    from ipoke_tpu_torch.cli.experiments import _registry, get_logger
    from ipoke_tpu_torch.core.config import Config

    config = copy.deepcopy(config)
    for section in FROZEN:
        if kind != section and isinstance(config.get(section), dict):
            config[section].pop("ckpt", None)
    config = Config(config)
    cls = _registry()[kind]
    e = cls.__new__(cls)
    e.prepare_config(config)
    seed = int(config.get("general", {}).get("seed", 42))
    e.config, e.device, e.logger, e.debug, e.step = config, torch.device("cpu"), \
        get_logger(), False, 0
    e.generator = torch.Generator().manual_seed(seed)
    e.init_generator = torch.Generator().manual_seed(seed)
    e.batch_size = int(config["data"].get("batch_size", 2))
    e.build()
    e._resume_template()
    return e


def _flat(tree, prefix=""):
    """{dotted path: array} of a nested numpy tree (the names of a
    ``ParamTree`` built from it); None leaves (masked buffers) left out."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None or getattr(tree, "dtype", None) == object:
        return {}  # a masked buffer's empty state
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _flow_tree(kind, tree):
    """The port's trainable tree of a flow experiment's JAX params."""
    return FLOWS[kind][1](tree)


def _names(root, params):
    """The names in ``root`` of ``params`` (an optimizer's list)."""
    by_id = {id(p): n for n, p in root.named_parameters()}
    return [by_id[id(p)] for p in params]


def _by_load(root, params, load):
    """``moments`` for ``convert.optax_state_dict``: a params-shaped tree
    loaded into a copy of ``root`` by ``load(copy, tree)``, then read in
    ``params`` order."""
    names = _names(root, params)

    def moments(tree):
        ref = copy.deepcopy(root)
        load(ref, tree)
        got = dict(ref.named_parameters())
        return [got[n].detach() for n in names]
    return moments


def _by_path(root, params, kind):
    """``moments`` for a flow tree: leaves by path (the port keeps the JAX
    layout, so any params-indexed tree maps, Adafactor's factored rows and
    columns too)."""
    names = _names(root, params)

    def moments(tree):
        flat = _flat(_flow_tree(kind, tree))
        missing = [n for n in names if n not in flat]
        if missing:
            raise ValueError(f"no optimizer leaf for the port's {missing[:3]}")
        return [torch.as_tensor(np.array(flat[n])) for n in names]
    return moments


def convert_tree(e, kind: str, tree, weights: bool, stats=None):
    """The port's checkpoint state (``weights``: its ``*_weights`` sidecar)
    of one JAX state tree of the experiment ``kind``, through the port's
    experiment ``e`` (``port_experiment``; every leaf the state holds is
    loaded anew); ``stats``: the spectral-norm stats of the state's sidecar
    (the flow VAE's)."""
    from ipoke_tpu_torch.convert import flow_params, load_flax, load_image_ae, optax_state_dict
    from ipoke_tpu_torch.flows import ParamTree

    if kind in FLOWS:
        root = FLOWS[kind][0](e)
        root.load_state_dict(ParamTree(flow_params(_flow_tree(kind, tree["params"])))
                             .state_dict())
        if weights:
            return e.export_weights()
        e.tx.load_state_dict(optax_state_dict(tree["opt"], e.tx,
                                              _by_path(root, e.tx.params, kind)))
        state = e.checkpoint_state()
        if "updates" in state:
            state["updates"] = int(tree["step"])
        return dict(state, step=int(tree["step"]))
    if kind in ("first_stage", "first_stage_fc"):
        nets = (e.model, e.disc_s, e.disc_t)
        if weights:
            load_flax(e.model, tree["params"], tree["stats"])
            return e.export_weights()
        for net, txs, key in zip(nets, e.trainer.tx, ("g", "ds", "dt")):
            params, stats_ = tree[f"params_{key}"], tree[f"stats_{key}"]
            load_flax(net, params, stats_)
            load = lambda ref, t, s=stats_: load_flax(ref, t, s)
            txs.load_state_dict(optax_state_dict(
                tree[f"opt_{key}"], txs, _by_load(net, txs.params, load), f"opt_{key}"))
        return dict(e.checkpoint_state(), step=int(tree["step"]))
    if kind in ("img_encoder", "poke_encoder", "img_encoder_fc", "poke_encoder_fc"):
        if weights:
            load_flax(e.model.ae, tree["params"], tree["stats"])
            return e.export_weights()
        load_image_ae(e.model, tree["params"], tree["stats"],
                      e.disc if e.use_disc else None, tree.get("params_d"),
                      tree.get("stats_d"))
        load = lambda ref, t: load_image_ae(ref, t, tree["stats"])
        e.tx.load_state_dict(optax_state_dict(
            tree["opt"], e.tx, _by_load(e.model, e.tx.params, load)))
        if e.use_disc:
            load = lambda ref, t: load_flax(ref, t, tree["stats_d"])
            e.tx_d.load_state_dict(optax_state_dict(
                tree["opt_d"], e.tx_d, _by_load(e.disc, e.tx_d.params, load), "opt_d"))
        return dict(e.checkpoint_state(), step=int(tree["step"]))
    if kind == "flow_encoder_fc":
        load_flax(e.model, tree["params"], tree.get("stats"))
        if weights:
            return e.export_weights()
        load_flax(e.disc, tree["params_d"], tree["stats_d"])
        e.tx.load_state_dict(optax_state_dict(
            tree["opt"], e.tx, _by_load(e.model, e.tx.params, load_flax)))
        load = lambda ref, t: load_flax(ref, t, tree["stats_d"])
        e.tx_d.load_state_dict(optax_state_dict(
            tree["opt_d"], e.tx_d, _by_load(e.disc, e.tx_d.params, load), "opt_d"))
        e.trainer.step.prev_d_loss = torch.as_tensor(np.array(tree["prev_d_loss"]))
        return dict(e.checkpoint_state(), step=int(tree["step"]))
    if kind == "flow_vae":
        stats = tree.get("stats", stats)
        if stats is None:
            raise ValueError("flow_vae: no spectral-norm stats (its *_weights sidecar)")
        load_flax(e.model, tree["params"], stats)
        if weights:
            return e.export_weights()
        load = lambda ref, t: load_flax(ref, t, stats)
        e.tx.load_state_dict(optax_state_dict(
            tree["opt"], e.tx, _by_load(e.model, e.tx.params, load)))
        return dict(e.checkpoint_state(), step=int(tree["step"]))
    raise ValueError(kind)


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
    e = port_experiment(kind, config)
    for name in sorted(os.listdir(vsrc)):
        path = os.path.join(vsrc, name)
        if not os.path.isdir(path):
            continue
        side = path + "_weights"
        stats = None
        if not name.endswith("_weights") and os.path.isdir(side):
            stats = read_orbax(side).get("stats")
        state = convert_tree(e, kind, read_orbax(path), name.endswith("_weights"), stats)
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
    log(f"{experiment}/{model_name}/{version}: converted with its optimizer state")


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
