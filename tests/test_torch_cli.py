"""The port's experiment layer and CLI on the CPU (``python -m
ipoke_tpu_torch.main ... --device cpu``), port only, at toy size: each of
the six conv experiments runs one epoch of 2 batches on a synthetic tree
and writes its run dir; ``--resume`` continues the step and the optimizer's
count (bf16 params and fp32 masters under ``mixed_prec_master``, no second
DDI); a NaN metric stops the run; what is not ported raises and names its
ROADMAP item (the FC experiments: ``tests/test_torch_cli_fc.py``)."""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from ipoke_tpu_torch import main as cli
from ipoke_tpu_torch.cli import experiments as ex
from ipoke_tpu_torch.data.prep import make_synthetic_dataset

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

S = 32
DATA = {"dataset": "PlantDataset", "poke_size": 3, "max_frames": 3,
        "batch_size": 2, "n_workers": 2, "spatial_size": [S, S],
        "augment": False, "n_pokes": 2, "zero_poke": True,
        "zero_poke_amount": 6, "scale_poke_to_res": True}
TRAIN = {"n_epochs": 1, "max_batches_per_epoch": 2, "max_val_batches": 1}
FS_ARCH = {"z_dim": 8, "ENC_M_channels": [16, 16, 32, 32],
           "dec_channels": [32, 32, 16, 16], "n_gru_layers": 2,
           "min_spatial_size": 4, "norm": "group", "spectral_norm": True,
           "motion_bias": True}
CONFIGS = {
    "img_encoder": {
        "architecture": {"nf_in": 3, "nf_max": 16, "min_spatial_size": 4,
                         "deterministic": True},
        "training": dict(TRAIN, lr=2e-4, perc_weight=1.0),
        "disc": {"ndf": 16, "n_layers": 2, "start": 0}},
    "poke_encoder": {
        "architecture": {"nf_in": 2, "nf_max": 16, "min_spatial_size": 4,
                         "deterministic": True},
        "training": dict(TRAIN, lr=2e-4, perc_weight=1.0)},
    "first_stage": {
        "architecture": FS_ARCH,
        "training": dict(TRAIN, lr=2e-4, w_kl=1e-6, w_l1=10, w_vgg=1,
                         gamma=0.98, full_sequence=True),
        "d_t": {"use": True, "pretrain": 0, "max_frames": 3, "gp_weight": 0.5,
                "gen_weight": 1.0, "fmap_weight": 1.0, "layers": [1, 1, 1, 1]},
        "d_s": {"use": True, "pretrain": 0, "n_examples": 4, "ndf": 16,
                "n_layers": 2}},
    "flow_vae": {
        "architecture": {"flow_vae_channels": 4, "flow_vae_nf_max": 16,
                         "min_spatial_size": 4},
        "training": dict(TRAIN, lr=1e-3, kl_weight=1e-6)},
}
# tests/test_second_stage.py's SS_CFG and the shipped recipe's precision
SS = {"architecture": {
    "flow_mid_channels_factor": 2, "kernel_size": [2, 3], "num_steps": [1, 1],
    "factor": 4, "activation": "elu", "transform": "affine",
    "prior_transform": "affine", "condition_nice": False,
    "augmented_input": False},
    "training": dict(TRAIN, lr=1e-3, lr_scaling_max_it=5, custom_lr_decrease=True,
                     spatial_mean=False, mixed_prec_master=True,
                     fused_nice_train=True)}
FM = {"architecture": {
    "num_steps": [1], "flow_mid_channels_factor": 2, "factor": 4,
    "kernel_size": [2, 3], "transform": "affine", "prior_transform": "affine",
    "activation": "elu", "flow_vae_channels": 4, "flow_vae_nf_max": 16},
    "training": dict(TRAIN, lr=1e-3, lr_scaling_max_it=5, weight_recon=1.0,
                     recon_scaling=True, spatial_mean=False)}


class Env:
    def __init__(self, root):
        self.root, self.data = str(root), str(root / "data")
        self.base = str(root / "logs")
        make_synthetic_dataset(self.data, n_videos=5, n_frames=14,
                               spatial_size=S, flow_delta=4)

    def run_dir(self, exp, version=0):
        return {"config": os.path.join(self.base, exp, "config", "tiny",
                                       f"{version}.yaml"),
                "ckpt": os.path.join(self.base, exp, "ckpt", "tiny", str(version))}

    def config(self, exp, body, name=None):
        cfg = dict(copy.deepcopy(body), general={"experiment": exp, "seed": 1},
                   data=dict(DATA))
        for sec, run in (("first_stage", "first_stage"),
                         ("conditioner", "img_encoder"),
                         ("poke_embedder", "poke_encoder")):
            if exp in ("second_stage", "flow_motion"):
                cfg[sec] = self.run_dir(run)
        if exp == "flow_motion":
            cfg["second_stage"] = self.run_dir("second_stage")
            cfg["flow_vae"] = {"ckpt": self.run_dir("flow_vae")["ckpt"]}
        path = os.path.join(self.root, f"{name or exp}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    def run(self, path, *extra, device="cpu"):
        os.environ["DATAPATH_BASE"] = self.base
        try:
            return cli.run(["--config", path, "--model_name", "tiny",
                            "--data_root", self.data, "--device", device, *extra])
        finally:
            os.environ.pop("DATAPATH_BASE", None)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The six experiments in pipeline order, one epoch of 2 batches each."""
    e = Env(tmp_path_factory.mktemp("cli"))
    e.runs = {}
    for exp in ("img_encoder", "poke_encoder", "first_stage", "flow_vae"):
        e.runs[exp] = e.run(e.config(exp, CONFIGS[exp]))
    e.runs["second_stage"] = e.run(e.config("second_stage", SS))
    e.runs["flow_motion"] = e.run(e.config("flow_motion", FM))
    return e


MONITOR = {"img_encoder": "lpips-val", "poke_encoder": "lpips-val",
           "first_stage": "FVD-val", "second_stage": "FVD-val",
           "flow_vae": "EE-val", "flow_motion": "EE-val"}


@pytest.mark.parametrize("exp", sorted(MONITOR))
def test_experiment_writes_its_run(env, exp):
    """The run dir, the config copy, the metrics log with finite train and
    val metrics, the best-k manifest, ``last`` and the ``*_weights``
    sidecars."""
    e = env.runs[exp]
    assert type(e) is ex.select_experiment(e.config)
    assert e.step == 2 and len(e.timings["step_s"]) == 2
    assert e.timings["device_allocs"] == [0, 0]
    assert all(0 <= d <= t for d, t in zip(e.timings["drain_s"], e.timings["step_s"]))
    d = env.run_dir(exp)
    assert os.path.exists(d["config"])
    for name in ("last", "last_weights"):
        assert os.path.exists(os.path.join(d["ckpt"], name, "state.pt")), name
    with open(os.path.join(d["ckpt"], "best_k_models.yaml")) as f:
        manifest = yaml.safe_load(f)
    (path, value), = manifest.items()
    assert os.path.basename(path) == f"step=2-{MONITOR[exp]}={value:.3f}"
    assert os.path.exists(path + "_weights")
    import json
    with open(e.metrics_logger.path) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if any(k.startswith("train/") for k in r)]
    val = [r for r in recs if f"val/{MONITOR[exp]}" in r]
    assert train and val
    assert all(np.isfinite(v) for r in recs for v in r.values())


def test_second_stage_resume_continues(env):
    """--resume: the step and the optimizer's count continue, bf16 params
    and fp32 masters come back as saved, and DDI does not rerun."""
    first = env.runs["second_stage"]
    assert first.ddi_runs == 1 and first.tx.count == 2
    path = env.config("second_stage", SS, name="second_stage_resume")
    args = cli.parse_args(["--config", path, "--model_name", "tiny",
                           "--data_root", env.data, "--resume", "--device", "cpu"])
    os.environ["DATAPATH_BASE"] = env.base
    try:
        cfg, dirs, _ = cli.load_parameters(args)
    finally:
        os.environ.pop("DATAPATH_BASE", None)
    check = ex.SecondStageExperiment(cfg, dirs, data_root=env.data, device="cpu")
    check.build()
    check.restore_last()
    check.metrics_logger.close()
    assert (check.step, check.tx.count, check.ddi_runs) == (2, 2, 0)
    for a, b in zip(check.model.flow_params.parameters(),
                    first.model.flow_params.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(check.tx.master, first.tx.master):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for q, r in zip(check.tx.inner.params, first.tx.inner.params):
        s, t = check.tx.inner.adam.state[q], first.tx.inner.adam.state[r]
        assert all(torch.equal(s[k], t[k]) for k in t)
    resumed = env.run(path, "--resume")
    assert (resumed.version, resumed.step, resumed.tx.count, resumed.ddi_runs) \
        == (0, 4, 4, 0)
    assert resumed.timings["restore_s"] is not None


@pytest.mark.parametrize("exp", ["img_encoder", "first_stage", "flow_vae"])
def test_resume_continues_optimizer_count(env, exp):
    path = env.config(exp, CONFIGS[exp], name=f"{exp}_resume")
    before = env.runs[exp].tx.count
    e = env.run(path, "--resume")
    assert (e.version, e.step, e.tx.count) == (0, 4, before + 2)


def test_debug_run_length_reaches_the_schedule(env):
    """``--debug``'s 2 epochs of 10 batches are the run the bridge's lr
    decays over, as ``n_epochs * max_batches`` of the JAX experiment."""
    from ipoke_tpu_torch.cli import fc_experiments as fc
    from ipoke_tpu_torch.core.optim import warmup_linear_decay

    path = env.config("flow_motion", FM, name="flow_motion_debug")
    args = cli.parse_args(["--config", path, "--model_name", "tiny",
                           "--data_root", env.data, "--debug", "--device", "cpu"])
    os.environ["DATAPATH_BASE"] = env.base
    try:
        cfg, dirs, _ = cli.load_parameters(args)
    finally:
        os.environ.pop("DATAPATH_BASE", None)
    e = fc.FlowMotionExperiment(cfg, dirs, data_root=env.data, device="cpu")
    e.build()
    e.metrics_logger.close()
    want = warmup_linear_decay(1e-3, 5, 20)
    assert [e.tx.schedule(c) for c in (0, 5, 12, 20, 25)] == \
        [want(c) for c in (0, 5, 12, 20, 25)]


def test_nan_metric_raises(env, monkeypatch):
    path = env.config("flow_vae", CONFIGS["flow_vae"], name="flow_vae_nan")
    real = ex.Experiment.train_step

    def nan_step(self, batch, epoch):
        return {"loss": torch.tensor(float("nan"))}

    monkeypatch.setattr("ipoke_tpu_torch.cli.fc_experiments.FlowVAEExperiment.train_step",
                        nan_step)
    with pytest.raises(FloatingPointError, match="loss=nan"):
        env.run(path)
    assert real is ex.Experiment.train_step


@pytest.mark.parametrize("name,item", [("pokevae_baseline", 5)])
def test_unported_experiments_raise(env, name, item):
    """The PokeVAE baseline (a first stage with ``architecture.baseline``,
    ROADMAP queue 1 item ``item``, refused until it was ported) trains an
    epoch through the CLI, validating under the batch's poke, and
    ``--resume`` restores its nets and their three optimizers bit for bit
    and goes on; every registered experiment now runs (the FC ones:
    ``tests/test_torch_cli_fc.py``)."""
    from ipoke_tpu_torch.models.poke_vae import PokeVAEModel

    path = os.path.join(env.root, f"unported_{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"general": {"experiment": "first_stage", "seed": 1}, "data": DATA,
                        **{k: v for k, v in CONFIGS["first_stage"].items()
                           if k != "architecture"},
                        "architecture": dict(FS_ARCH, baseline=True,
                                             stack_motion_and_poke=True)}, f)
    argv = ["--config", path, "--model_name", name, "--data_root", env.data,
            "--device", "cpu"]
    os.environ["DATAPATH_BASE"] = env.base
    try:
        first = cli.run(argv)
        assert isinstance(first.model, PokeVAEModel)
        assert (first.step, first.tx.count) == (2, 2)
        with open(first.metrics_logger.path) as f:
            val = [r for r in map(json.loads, f) if "val/FVD-val" in r]
        assert val and all(np.isfinite(v) for r in val for v in r.values())
        args = cli.parse_args(argv + ["--resume"])
        cfg, dirs, _ = cli.load_parameters(args)
        check = ex.FirstStageExperiment(cfg, dirs, data_root=env.data, device="cpu")
        check.build()
        check.restore_last()
        check.metrics_logger.close()
        for a, b in zip(check.trainer.tx, first.trainer.tx):
            assert a.count == b.count == 2
            for q, r in zip(a.params, b.params):
                assert torch.equal(q, r)
                assert all(torch.equal(a.adam.state[q][k], b.adam.state[r][k])
                           for k in b.adam.state[r])
        resumed = cli.run(argv + ["--resume"])
    finally:
        os.environ.pop("DATAPATH_BASE", None)
    assert (resumed.version, resumed.step, resumed.tx.count) == (0, 4, 4)


@pytest.mark.parametrize("extra,error,match", [
    (["--test", "fvd"], AssertionError, "no frozen-submodel sampler"),
    (["--test", "samples"], AssertionError, "no frozen-submodel sampler"),
    (["--devices", "2"], NotImplementedError,
     "JAX CLI stores --devices and shards nothing either.*ipoke_tpu_torch.parallel")])
def test_unported_flags_raise(env, extra, error, match):
    """``--devices 2`` raises rather than be ignored (the JAX CLI reads it
    and shards nothing; the port's sharded step is
    ``ipoke_tpu_torch.parallel``); the ``--test`` modes are ported
    (``tests/test_torch_cli_testing.py``) and refuse, as the JAX package's
    do, an experiment without a sampling pipeline (the flow VAE)."""
    with pytest.raises(error, match=match):
        env.run(env.config("flow_vae", CONFIGS["flow_vae"], name="flags"), *extra)


def test_device_cuda_without_card_raises(tmp_path, monkeypatch):
    """``--device cuda`` (the default) raises before any run dir is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DATAPATH_BASE", str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["--config", "config/flow_vae.yaml", "--model_name", "x"])
    assert not os.path.exists(tmp_path / "logs")


def test_devices_one_and_gpus_accepted():
    args = cli.parse_args(["--config", "c.yaml", "--model_name", "m",
                           "--devices", "1", "--gpus", "0,1", "--device", "cpu"])
    cli.check_args(args)
    assert args.device == "cpu" and cli.parse_args(
        ["--config", "c.yaml", "--model_name", "m"]).device == "cuda"
