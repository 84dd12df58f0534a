"""The FC tower through the port's CLI (``python -m ipoke_tpu_torch.main ...
--device cpu``) at toy size (32 px), on the synthetic tree of
``tests/test_torch_cli.py``: ``flow_encoder_fc`` (the BigAE on flow maps,
and on frames as ``config/img_encoder_fc.yaml`` sets it), ``img_encoder_fc``,
``poke_encoder_FC`` (the reference's casing), ``first_stage_fc``,
``inn_fcae`` over the flow encoder, ``second_stage_fc`` over the FC
first stage and encoders and ``third_stage_fc`` over the second stage and
flow encoder (unconditioned and poke-conditioned), one epoch of 2 batches
each: each writes its run dir with finite train and validation metrics;
``second_stage_fc`` resumes without a second DDI and runs the seven
``--test`` modes, whose FVD the JAX package's mode gives on the same clips;
``third_stage_fc`` resumes, runs ``--test realism`` and ``accuracy`` and
samples video from measured flow; the torch counterparts of the FC root
scripts run on the tree; ``main.run`` leaves TF32 off."""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from ipoke_tpu_torch import main as cli
from ipoke_tpu_torch.cli import experiments as ex

from test_torch_cli import CONFIGS, DATA, TRAIN, Env
from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

FC = {
    "flow_encoder_fc": {
        "architecture": {"z_dim": 8, "n_out_channels": 2, "gen_ch": 4},
        "training": dict(TRAIN, lr=2e-4, perc_weight=1.0, kl_weight=1e-6, disc_weight=1.0),
        "disc": {"ndf": 8, "n_layers": 2, "start": 0}},
    "img_encoder_fc": {
        "architecture": {"nf_in": 3, "nf_max": 16, "deterministic": True},
        "training": dict(TRAIN, lr=2e-4, perc_weight=1.0),
        "disc": {"ndf": 8, "n_layers": 2, "start": 0}},
    "poke_encoder_FC": {
        "architecture": {"nf_in": 2, "nf_max": 16, "deterministic": True},
        "training": dict(TRAIN, lr=2e-4, perc_weight=1.0)},
    "first_stage_fc": dict(copy.deepcopy(CONFIGS["first_stage"]), architecture={
        "fc_baseline": True, "z_dim": 8, "ENC_M_channels": [16, 16, 32, 32],
        "dec_channels": [32, 32, 16, 16], "n_gru_layers": 2, "CN_content": "spade"}),
    "inn_fcae": {
        "architecture": {"n_flows": 2, "flow_hidden_depth": 2},
        "training": dict(TRAIN, lr=1e-3, lr_scaling_max_it=5)},
    "second_stage_fc": {
        "architecture": {"flow_mid_channels_factor": 2, "flow_hidden_depth": 2,
                         "n_flows": 3},
        "training": dict(TRAIN, lr=1e-3, lr_scaling_max_it=5,
                         base_distribution="gaussian"),
        "testing": {"n_samples_per_data_point": 2}},
    "third_stage_fc": {
        "architecture": {"flow_mid_channels_factor": 2, "flow_hidden_depth": 2,
                         "n_flows": 3},
        "training": dict(TRAIN, lr=1e-3, lr_scaling_max_it=5, weight_recon=1.0,
                         recon_scaling=True),
        "testing": {"n_samples_per_data_point": 2}, "logging": {"n_log_images": 2}},
}
# the frozen runs each experiment reads: (section, run, extra keys)
FROZEN = {
    "inn_fcae": [("flow_encoder", "flow_encoder_fc", {})],
    "second_stage_fc": [("first_stage", "first_stage_fc", {}),
                        ("conditioner", "img_encoder_fc", {"nf_max": 16}),
                        ("poke_embedder", "poke_encoder_FC", {"nf_max": 16})]}
FROZEN["third_stage_fc"] = FROZEN["second_stage_fc"] + [
    ("second_stage", "second_stage_fc", {}), ("flow_encoder", "flow_encoder_fc", {})]
MONITOR = {"flow_encoder_fc": "lpips-val", "flow_encoder_fc_images": "lpips-val",
           "img_encoder_fc": "lpips-val", "poke_encoder_FC": "lpips-val",
           "first_stage_fc": "FVD-val", "inn_fcae": "flow_loss-val",
           "second_stage_fc": "FVD-val", "third_stage_fc": "EE_R3-val",
           "third_stage_fc_conditional": "EE_R3-val"}
MODES = ("samples", "fvd", "accuracy", "diversity", "control_sensitivity", "transfer",
         "kps_acc")


class FCEnv(Env):
    def fc_config(self, exp, name=None):
        """``exp``'s toy config (``flow_encoder_fc_images``: the BigAE on
        frames, as config/img_encoder_fc.yaml; ``third_stage_fc_conditional``
        with ``general.conditional``) with its frozen runs' dirs."""
        base = {"flow_encoder_fc_images": "flow_encoder_fc",
                "third_stage_fc_conditional": "third_stage_fc"}.get(exp, exp)
        cfg = dict(copy.deepcopy(FC[base]), data=dict(DATA), general={
            "experiment": base, "seed": 1})
        if exp == "flow_encoder_fc_images":
            cfg["architecture"]["n_out_channels"] = 3
        if exp == "third_stage_fc_conditional":
            cfg["general"]["conditional"] = True
        for sec, run, extra in FROZEN.get(base, ()):
            cfg[sec] = dict(self.run_dir(run), **extra)
        path = os.path.join(self.root, f"{name or exp}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    def run_named(self, path, model_name, *extra):
        os.environ["DATAPATH_BASE"] = self.base
        try:
            return cli.run(["--config", path, "--model_name", model_name,
                            "--data_root", self.data, "--device", "cpu", *extra])
        finally:
            os.environ.pop("DATAPATH_BASE", None)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The FC experiments in pipeline order, one epoch of 2 batches each."""
    e = FCEnv(tmp_path_factory.mktemp("cli_fc"))
    e.runs = {}
    for exp in ("flow_encoder_fc", "img_encoder_fc", "poke_encoder_FC", "first_stage_fc",
                "inn_fcae", "second_stage_fc"):
        e.runs[exp] = e.run(e.fc_config(exp))
    e.runs["third_stage_fc"] = e.run(e.fc_config("third_stage_fc"))
    for exp, model_name in (("flow_encoder_fc_images", "images"),
                            ("third_stage_fc_conditional", "conditional")):
        e.runs[exp] = e.run_named(e.fc_config(exp), model_name)
    e.ss_path = os.path.join(e.root, "second_stage_fc.yaml")
    e.gen = os.path.join(e.base, "second_stage_fc", "generated", "tiny")
    e.ts_path = os.path.join(e.root, "third_stage_fc.yaml")
    return e


@pytest.mark.parametrize("exp", sorted(MONITOR))
def test_fc_experiment_writes_its_run(env, exp):
    """The run dir, ``last`` and the monitored checkpoint with their
    ``*_weights``, finite train and validation metrics."""
    e = env.runs[exp]
    assert type(e) is ex.select_experiment(e.config)
    assert e.step == 2 and len(e.timings["step_s"]) == 2
    for name in ("last", "last_weights"):
        assert os.path.exists(os.path.join(e.version_dir, name, "state.pt")), name
    with open(os.path.join(e.version_dir, "best_k_models.yaml")) as f:
        (path, value), = yaml.safe_load(f).items()
    assert os.path.basename(path) == f"step=2-{MONITOR[exp]}={value:.3f}"
    assert os.path.exists(path + "_weights")
    with open(e.metrics_logger.path) as f:
        recs = [json.loads(line) for line in f]
    assert any(k.startswith("train/") for r in recs for k in r)
    assert any(f"val/{MONITOR[exp]}" in r for r in recs)
    assert all(np.isfinite(v) for r in recs for v in r.values())


def test_fc_runs_are_what_the_yamls_name(env):
    """The FC first stage is the FC baseline; the BigAE trains on the
    channels it is given; the FC second stage ran DDI once."""
    from ipoke_tpu_torch.models.fc_baseline import FCBaselineModel, SecondStageModelFC

    assert isinstance(env.runs["first_stage_fc"].model, FCBaselineModel)
    assert env.runs["flow_encoder_fc"].model.in_channels == 2
    assert env.runs["flow_encoder_fc_images"].model.in_channels == 3
    ss = env.runs["second_stage_fc"]
    assert isinstance(ss.model, SecondStageModelFC) and ss.ddi_runs == 1
    assert type(env.runs["poke_encoder_FC"]) is ex.select_experiment(
        env.runs["poke_encoder_FC"].config)


def test_second_stage_fc_resume_continues(env):
    """--resume: the step and the optimizer's count go on, DDI does not
    rerun, and the restored flow is the run's own."""
    from ipoke_tpu_torch.cli.fc_experiments import SecondStageFCExperiment

    first = env.runs["second_stage_fc"]
    path = env.fc_config("second_stage_fc", "second_stage_fc_resume")
    os.environ["DATAPATH_BASE"] = env.base
    try:
        cfg, dirs, _ = cli.load_parameters(cli.parse_args(
            ["--config", path, "--model_name", "tiny", "--resume", "--device", "cpu"]))
    finally:
        os.environ.pop("DATAPATH_BASE", None)
    check = SecondStageFCExperiment(cfg, dirs, data_root=env.data, device="cpu")
    check.build()
    check.restore_last()
    check.metrics_logger.close()
    assert (check.step, check.tx.count, check.ddi_runs) == (2, 2, 0)
    assert all(torch.equal(a, b) for a, b in zip(check.model.flow_params.parameters(),
                                                 first.model.flow_params.parameters()))
    resumed = env.run(path, "--resume")
    assert (resumed.version, resumed.step, resumed.tx.count, resumed.ddi_runs) == (0, 4, 4, 0)
    assert resumed.timings["restore_s"] is not None
    assert first.tx.count == 2


@pytest.mark.parametrize("mode", MODES)
def test_second_stage_fc_test_modes(env, mode):
    """Each ``--test`` mode on the FC second stage: finite metrics, and the
    files the mode writes."""
    result = env.run(env.ss_path, "--test", mode, "--debug")
    assert result and all(np.isfinite(v) for v in result.values()), result
    d = os.path.join(env.gen, mode)
    assert os.listdir(d)
    if mode == "samples":
        samples = np.load(os.path.join(d, "samples_batch0.npy"))
        assert samples.shape == (2, 2, 3, 32, 32, 3) and np.isfinite(samples).all()
    if mode == "fvd":
        with open(os.path.join(d, "fvd.json")) as f:
            assert json.load(f) == result


def test_fc_fvd_matches_jax(env, tmp_path, monkeypatch):
    """The JAX package's ``--test fvd`` and the port's on the FC run's
    sampled clips (``--test samples``' dump) and real clips, through stub
    runs that hand both the same clips in draw order: the FVD within 1e-5
    relative."""
    import jax

    from ipoke_tpu.cli import testing as jtesting
    from ipoke_tpu_torch.cli import testing as ttesting

    from test_torch_testing import _JaxRun, _PortRun

    env.run(env.ss_path, "--test", "samples", "--debug")
    d = os.path.join(env.gen, "samples")
    samples = np.load(os.path.join(d, "samples_batch0.npy"))
    real = np.load(os.path.join(d, "real_batch0.npy"))
    videos = [samples[:, 0], samples[:, 1]]
    poke = np.zeros((*real.shape[:1], *real.shape[2:4], 2), np.float32)
    batches = [{"images": real, "poke": poke}, {"images": real[::-1].copy(), "poke": poke}]
    jrun = _JaxRun(videos, batches, str(tmp_path / "jax"))
    prun = _PortRun(videos, batches, str(tmp_path / "port"))
    with jax.disable_jit():
        want = jtesting.test_fvd(jrun)
    got = ttesting.test_fvd(prun)
    assert jrun.i == prun.i == 2 and got.keys() == want.keys()
    np.testing.assert_allclose(got["FVD"], want["FVD"], rtol=1e-5)
    assert got["n_samples"] == want["n_samples"] == 4.0


def test_third_stage_fc_resume_continues(env):
    """--resume of the FC third stage: the restored INN and optimizer are
    the run's own, the step and the optimizer's count go on; the
    conditioned run's INN sees the poke embedding (16 entries); each
    samples video from measured flow through its model."""
    from ipoke_tpu_torch.cli.fc_experiments import ThirdStageFCExperiment
    from ipoke_tpu_torch.flows.fc import ConditionalFlatFlow

    first = env.runs["third_stage_fc"]
    path = env.fc_config("third_stage_fc", "third_stage_fc_resume")
    os.environ["DATAPATH_BASE"] = env.base
    try:
        cfg, dirs, _ = cli.load_parameters(cli.parse_args(
            ["--config", path, "--model_name", "tiny", "--resume", "--device", "cpu"]))
    finally:
        os.environ.pop("DATAPATH_BASE", None)
    check = ThirdStageFCExperiment(cfg, dirs, data_root=env.data, device="cpu")
    check.build()
    check.restore_last()
    check.metrics_logger.close()
    assert (check.step, check.tx.count, check.trainer.state.step) == (2, 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(check.model.inn_params.parameters(),
                                                 first.model.inn_params.parameters()))
    resumed = env.run(path, "--resume")
    assert (resumed.version, resumed.step, resumed.tx.count) == (0, 4, 4)
    assert first.tx.count == 2 and first.model.z_total == first.model.z_flow == 8
    cond = env.runs["third_stage_fc_conditional"]
    assert isinstance(cond.model.inn, ConditionalFlatFlow) and cond.model.poke_cond_dim == 16
    batch = next(iter(first.val_batches(0)))
    for e in (first, cond):
        video = e.sample_video(batch, DATA["max_frames"])
        assert video.shape == (2, DATA["max_frames"], 32, 32, 3) and torch.isfinite(video).all()


@pytest.mark.parametrize("mode", ["realism", "accuracy"])
def test_third_stage_fc_test_modes(env, mode):
    """``--test realism`` and the third stage's ``--test accuracy`` on the
    toy run: the JAX package's files and metric keys, finite metrics."""
    result = env.run(env.ts_path, "--test", mode, "--debug")
    assert result and all(np.isfinite(v) for v in result.values()), result
    d = os.path.join(env.base, "third_stage_fc", "generated", "tiny", mode)
    with open(os.path.join(d, "metrics.json")) as f:
        assert json.load(f) == result
    if mode == "realism":
        assert set(result) == {"FID", "n_samples"} and result["n_samples"] == 4
        return
    assert set(result) == {f"AE_R{a}" for a in (5, 10, 15)} | {f"EE_R{p}" for p in (1, 2, 3, 5)}
    n = DATA["n_pokes"]
    assert sorted(os.listdir(d)) == sorted([
        f"error_result_{n}_pokes.yaml", "metrics.json", f"pokes_diversity_{n}_pokes.npy",
        f"samples_diversity_{n}_pokes.npy", f"starting_frame_{n}_pokes.npy"])
    stack = np.load(os.path.join(d, f"samples_diversity_{n}_pokes.npy"))
    assert stack.shape == (2 + 2, 2 * 2, 32, 32, 3) and stack.dtype == np.uint8


@pytest.mark.parametrize("script,exp,toy", [
    ("FlowAutoencoderFC", "flow_encoder_fc", "flow_encoder_fc"),
    ("ImgAutoencoderFC", "flow_encoder_fc", "flow_encoder_fc_images"),
    ("VidAutoencoderFC", "first_stage_fc", "first_stage_fc"),
    ("INN_FCAE", "inn_fcae", "inn_fcae"),
    ("INN_test", "flow_motion", None), ("opticalFlowINN", "flow_motion", None)])
def test_root_script_counterparts(env, script, exp, toy, monkeypatch):
    """Each torch counterpart of a root script: run as ``python -m`` it
    hands ``main.run`` the argv of its default YAML (the root script's),
    which names the experiment it trains; ``run`` trains the toy config on
    the tree (the conv third stage's two scripts run ``flow_motion``, which
    ``tests/test_torch_cli.py`` trains); ``FCAE_eval`` gives the trained
    flow encoder's error categories."""
    import importlib.util
    import runpy

    from ipoke_tpu_torch.core.config import load_config
    from ipoke_tpu_torch.scripts import run

    default = {"ImgAutoencoderFC": "config/img_encoder_fc.yaml",
               "INN_test": "config/flow_motion.yaml"}.get(
        script, f"config/{ {'opticalFlowINN': 'flow_motion'}.get(script, exp)}.yaml")
    assert load_config(default)["general"]["experiment"] == exp
    with monkeypatch.context() as m:
        calls = []
        m.setattr(cli, "run", calls.append)
        m.setattr("sys.argv", [script])
        with pytest.raises(SystemExit) as stop:
            # by path: pytest's import hook claims modules named like tests
            runpy.run_path(importlib.util.find_spec(
                f"ipoke_tpu_torch.scripts.{script}").origin, run_name="__main__")
    assert stop.value.code == 0
    assert calls == [["--config", default, "--model_name", "fcae", "--device", "cuda"]]
    if toy is None:
        return
    monkeypatch.setenv("DATAPATH_BASE", env.base)
    path = env.fc_config(toy, f"script_{script}")
    assert run(exp, default, ["-c", path, "--model_name", script, "--data_root", env.data,
                              "--device", "cpu"]) == 0
    with open(os.path.join(env.base, exp, "log", script, "0", "metrics.jsonl")) as f:
        assert any('"val/' in line for line in f)
    if script == "FlowAutoencoderFC":
        from ipoke_tpu_torch.scripts.FCAE_eval import evaluate

        got = evaluate(path, script, env.data, n_batches=1, device="cpu")
        assert set(got) == {f"AE_R{a}" for a in (5, 10, 15)} | {f"EE_R{p}" for p in (1, 2, 3, 5)}
        assert all(0 <= v <= 1 for v in got.values())


def test_main_turns_tf32_off(env):
    """``main.run`` sets both TF32 switches off before it builds the
    experiment (the precision every parity tolerance assumes)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        env.run(env.ss_path, "--test", "fvd", "--debug")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
