"""JAX-trained runs in the port (``tools/jax_run_to_torch.py``), the conv
pipeline's four experiments: toy states saved by the JAX package's
``CheckpointStore`` (no training run) are converted and restored by the
port's store, every leaf equal to its JAX value, the manifest, config and
log kept; the converted second stage then resumes through ``python -m
ipoke_tpu_torch.main --resume`` with its optimizer (AMSGrad's moments and
the schedule's count) carried over.  One port step from a converted state
against the JAX step from the same state:
``test_torch_cli_parity.py::test_poke_embedder_steps_match_jax`` (its JAX
program), through this tool; the other nine experiments and the optimizer
rules: ``tests/test_torch_jax_runs.py``."""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from ipoke_tpu.core.checkpoint import CheckpointStore as JStore
from ipoke_tpu.core.config import Config as JConfig
from ipoke_tpu.core.optim import flow_adam as jax_flow_adam
from ipoke_tpu.core.optim import gan_adam as jax_gan_adam
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.models import image_ae as jae
from ipoke_tpu.models.second_stage import FlowTrainState
from ipoke_tpu.nn import PatchDiscriminator2D as JaxPatchDisc
from ipoke_tpu_torch import entry
from ipoke_tpu_torch import main as cli
from ipoke_tpu_torch.cli.experiments import load_frozen
from ipoke_tpu_torch.convert import flow_params, jax_second_stage_params, load_flax
from ipoke_tpu_torch.core.checkpoint import CheckpointStore
from ipoke_tpu_torch.core.config import Config
from ipoke_tpu_torch.data.prep import make_synthetic_dataset
from ipoke_tpu_torch.flows import ParamTree
from ipoke_tpu_torch.models.second_stage import SecondStageModel
from tools.jax_run_to_torch import convert_runs, port_experiment

from test_torch_cli import CONFIGS as CLI_CONFIGS, DATA, FS_ARCH, S, SS, TRAIN
from test_torch_image_ae import CONFIGS as AE_CONFIGS, _jax_state, _like
from test_torch_ops import _few_threads, _jnp  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill

K = jax.random.PRNGKey


def _ss_config(src):
    """A toy fp32 second stage whose frozen nets are drawn from the seed
    (no runs named), its base dir under ``src``."""
    cfg = dict(copy.deepcopy(SS), data=dict(DATA),
               general={"experiment": "second_stage", "seed": 1, "base_dir": src})
    cfg["training"].update(mixed_prec_master=False, fused_nice_train=False)
    size = {"spatial_size": [S, S], "max_frames": DATA["max_frames"]}
    cfg["first_stage"] = {"config": {"data": size, "architecture": FS_ARCH,
                                     "training": {}, "d_s": {}, "d_t": {}}}
    for sec, run in (("conditioner", "img_encoder"), ("poke_embedder", "poke_encoder")):
        cfg[sec] = {"config": {"data": size,
                               "architecture": CLI_CONFIGS[run]["architecture"]}}
    cfg["conditioner"]["use"] = True
    return cfg


def _save_jax_run(src, exp, cfg, states, weights):
    """``states`` [(step, metric, state)] saved by the JAX store as the
    version 0 of the run ``toy`` of ``exp``, with its config and a log."""
    store = JStore(os.path.join(src, exp, "ckpt", "toy", "0"))
    for step, metric, state in states:
        store.save(state, step, metric=metric, weights=weights)
    for sub, name, text in (("config", "0.yaml", yaml.safe_dump(cfg)),
                            ("log", os.path.join("0", "metrics.jsonl"), "{}\n")):
        path = os.path.join(src, exp, sub, "toy", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return store


@pytest.fixture(scope="module")
def second_stage(tmp_path_factory):
    """A JAX second-stage run (two monitored epochs) converted into the
    port's layout."""
    root = tmp_path_factory.mktemp("jax_run")
    src, dst = str(root / "jax"), str(root / "port")
    cfg = _ss_config(src)
    model = SecondStageModel(Config(cfg), *load_frozen(Config(cfg),
                                                       torch.Generator().manual_seed(0)))
    model.flow_params = ParamTree(model.init_params(torch.Generator().manual_seed(1), "cpu"))
    entry.perturb(model.flow_params, torch.Generator().manual_seed(2))
    params = _jnp(jax_second_stage_params(model))
    # the JAX experiment's optimizer (AMSGrad over the trainable leaves), 3
    # updates in (inside the toy run's 5-step warmup, so the next steps'
    # lr is not 0): its moments drawn, positive where they must be
    opt = jax_flow_adam(1e-3, params=params).init(params)
    rng = np.random.default_rng(9)
    opt = jax.tree_util.tree_map(
        lambda a: np.int32(3) if a.shape == () else
        np.abs(rng.standard_normal(a.shape)).astype(a.dtype) * 1e-3, opt)
    state = FlowTrainState(params=params, opt=_jnp(opt), step=np.int32(7))
    jstore = _save_jax_run(src, "second_stage", cfg,
                           [(5, 2.5, state.replace(step=np.int32(5))), (7, 1.5, state)],
                           {"params": params})
    lines = []
    assert convert_runs(src, dst, log=lines.append) == 1
    return src, dst, jstore, jax_second_stage_params(model), lines, opt


def test_second_stage_leaves_manifest_and_config(second_stage):
    src, dst, jstore, tree, lines, opt = second_stage
    store = CheckpointStore(os.path.join(dst, "second_stage", "ckpt", "toy", "0"))
    want = ParamTree(flow_params(tree["flow"])).state_dict()
    for name, step in (("last", 7), ("step=7-loss=1.500", 7), ("step=5-loss=2.500", 5)):
        state = store.restore(name)
        assert state["tx"]["count"] == 3 and state["step"] == step
        assert state["flow"].keys() == want.keys()
        for k, v in want.items():
            torch.testing.assert_close(state["flow"][k], v, rtol=0, atol=0)
        weights = store.restore(name + "_weights")
        for k, v in want.items():
            torch.testing.assert_close(weights[k], v, rtol=0, atol=0)
    jm = {os.path.basename(k): v for k, v in jstore._load_manifest().items()}
    pm = store._load_manifest()
    assert {os.path.basename(k): v for k, v in pm.items()} == jm
    assert all(k.startswith(dst) and os.path.exists(k) for k in pm)
    assert store.best_path().endswith("step=7-loss=1.500")
    with open(os.path.join(dst, "second_stage", "config", "toy", "0.yaml")) as f:
        assert yaml.safe_load(f)["general"]["base_dir"] == dst
    assert os.path.exists(os.path.join(dst, "second_stage", "log", "toy", "0",
                                       "metrics.jsonl"))
    assert any("with its optimizer state" in line for line in lines)
    # AMSGrad's first moments by leaf path, in the port's optimizer order
    rule = opt.inner_states["train"].inner_state[1]
    adam = state["tx"]["adam"]["state"]
    names = [n for n, _ in ParamTree(flow_params(tree["flow"])).named_parameters()]
    mu = ParamTree(flow_params(jax.tree_util.tree_map(
        lambda a: a if isinstance(a, np.ndarray) else np.zeros(0, np.float32),
        rule.mu["flow"]))).state_dict()
    assert len(adam) == len(names)
    for i, n in enumerate(names):
        assert float(adam[i]["step"]) == 3
        torch.testing.assert_close(adam[i]["exp_avg"], mu[n], rtol=0, atol=0)


def test_converted_second_stage_resumes(second_stage, tmp_path):
    """``main --resume`` on the converted run: the step goes on from the
    JAX state's 7, and the optimizer's count (the lr schedule's) from its 3,
    and the params move from the converted ones."""
    _, dst, _, tree, _, _ = second_stage
    data = str(tmp_path / "data")
    make_synthetic_dataset(data, n_videos=5, n_frames=14, spatial_size=S, flow_delta=4)
    e = cli.run(["--config", os.path.join(dst, "second_stage", "config", "toy", "0.yaml"),
                 "--model_name", "toy", "--resume", "--data_root", data,
                 "--device", "cpu"])
    assert e.step == 7 + TRAIN["max_batches_per_epoch"]
    assert e.trainer.tx.count == 3 + TRAIN["max_batches_per_epoch"]
    assert e.ddi_runs == 0
    before = ParamTree(flow_params(tree["flow"])).state_dict()
    after = e.model.flow_params.state_dict()
    assert any(not torch.equal(after[k], v) for k, v in before.items())


def _first_stage_state():
    cfg = dict(copy.deepcopy(CLI_CONFIGS["first_stage"]),
               data={"spatial_size": [S, S], "max_frames": DATA["max_frames"]},
               general={"experiment": "first_stage"})
    jcfg = JConfig(copy.deepcopy(cfg))
    nets = jfs.build_first_stage(jcfg)
    tx = jax_gan_adam(1e-3)
    shapes = jax.eval_shape(lambda: jfs.create_first_stage_state(
        K(0), jcfg, *nets, tx, tx, tx))
    rng = np.random.default_rng(4)
    vals = {k: _jnp(_fill(getattr(shapes, k), rng)) for k in (
        "params_g", "params_ds", "params_dt", "stats_g", "stats_ds", "stats_dt")}
    state = jfs.GANTrainState(**vals, opt_g=tx.init(vals["params_g"]),
                              opt_ds=tx.init(vals["params_ds"]),
                              opt_dt=tx.init(vals["params_dt"]), step=np.int32(3))
    return cfg, state, {"params": vals["params_g"], "stats": vals["stats_g"]}


def _image_ae_state():
    cfg = dict(copy.deepcopy(AE_CONFIGS["conditioner"]),
               general={"experiment": "img_encoder"})
    jcfg = JConfig(copy.deepcopy(cfg))
    tx = jax_gan_adam(1e-3)
    state = _jax_state(jcfg, jae.build_image_ae(jcfg), JaxPatchDisc(ndf=8, n_layers=2),
                       tx, True).replace(step=np.int32(4))
    return cfg, state, {"params": state.params["ae"], "stats": state.stats}


@pytest.mark.parametrize("exp", ["first_stage", "img_encoder"])
def test_nets_leaves_equal(exp, tmp_path):
    """The first stage (generator with live spectral norms, both
    discriminators) and the image AE (with its discriminator): every
    param, spectral-norm u and sigma, and the ``*_weights`` sidecar equal
    to the JAX values."""
    cfg, state, weights = (_first_stage_state if exp == "first_stage"
                           else _image_ae_state)()
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    _save_jax_run(src, exp, cfg, [(int(state.step), 1.0, state)], weights)
    assert convert_runs(src, dst, log=lambda line: None) == 1
    store = CheckpointStore(os.path.join(dst, exp, "ckpt", "toy", "0"))
    got = store.restore("last")
    assert got["step"] == int(state.step)
    e = port_experiment(exp, cfg)
    nets = (e.model, e.disc_s, e.disc_t) if exp == "first_stage" else (e.model, e.disc)
    if exp == "first_stage":
        pairs = [(nets[0], got["model"], state.params_g, state.stats_g),
                 (nets[1], got["disc_s"], state.params_ds, state.stats_ds),
                 (nets[2], got["disc_t"], state.params_dt, state.stats_dt)]
        sidecar = (nets[0], weights["params"], weights["stats"])
    else:
        pairs = [(nets[0].ae, {k[3:]: v for k, v in got["model"].items()
                               if k.startswith("ae.")}, state.params["ae"], state.stats),
                 (nets[1], got["disc"], state.params_d, state.stats_d)]
        torch.testing.assert_close(got["model"]["logvar"],
                                   torch.tensor(np.asarray(state.params["logvar"])))
        sidecar = (nets[0].ae, weights["params"], weights["stats"])
    for net, sd, params, stats in pairs:
        net.load_state_dict(sd)
        for a, w in zip(net.parameters(), _like(net, params, stats)):
            torch.testing.assert_close(a.detach(), w, rtol=0, atol=0)
        ref = copy.deepcopy(net)
        load_flax(ref, params, stats)
        for (name, a), b in zip(net.named_buffers(), ref.buffers()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    net, params, stats = sidecar
    side = store.restore("last_weights")
    ref = copy.deepcopy(net)
    load_flax(ref, params, stats)
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(side[k], v, rtol=0, atol=0)
