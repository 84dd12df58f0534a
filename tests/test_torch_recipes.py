"""The eight reproduction recipes of ``config/pretrained_models/`` through
the port, on the CPU, port only: each builds as a ``SecondStageExperiment``
with its Adafactor (``training.use_adafactor``), its frozen nets named
through a registry file (``IPOKE_TPU_REGISTRY``) of toy configs without
checkpoints (random weights from the seed), with the cINN's depth and width
cut in the test only; and ``plants_64.yaml``, cut to the toy pipeline of
``tests/test_torch_cli.py``, trains an epoch through ``main.run`` and
``--resume``s with its Adafactor state restored bitwise."""

import copy
import glob
import os

import pytest
import torch
import yaml

from ipoke_tpu_torch import main as cli
from ipoke_tpu_torch.cli import experiments as ex
from ipoke_tpu_torch.core.config import load_config
from ipoke_tpu_torch.core.optim import Adafactor

from test_torch_cli import CONFIGS, DATA, FS_ARCH, TRAIN, Env
from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

RECIPES = sorted(glob.glob(os.path.join("config", "pretrained_models", "*.yaml")))
CUT = {"num_steps": [1, 1], "flow_mid_channels_factor": 2}  # depth and width


def _registry(root, spatial, names, latent=8):
    """A registry file naming toy frozen configs (no ckpt) for ``names``:
    the first stage of ``tests/test_torch_cli.py`` with ``latent`` x
    ``latent`` latents, and its image and poke encoders, at ``spatial``
    px."""
    data = dict(DATA, spatial_size=[spatial, spatial])
    sub = {"first_stage": dict(copy.deepcopy(CONFIGS["first_stage"]), data=data,
                               architecture=dict(FS_ARCH, min_spatial_size=latent)),
           "conditioner": dict(copy.deepcopy(CONFIGS["img_encoder"]), data=data),
           "poke_embedder": dict(copy.deepcopy(CONFIGS["poke_encoder"]), data=data)}
    for c in sub.values():
        c["architecture"]["min_spatial_size"] = latent
    reg = {}
    for sec, section in (("first_stage", "first_stage_models"),
                         ("conditioner", "conditioner_models"),
                         ("poke_embedder", "poke_embedder_models")):
        path = os.path.join(root, f"{sec}_{spatial}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(sub[sec], f)
        reg[section] = {names[sec]: {"config": path}}
    path = os.path.join(root, f"registry_{spatial}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(reg, f)
    return path


def test_all_eight_recipes_are_listed():
    assert len(RECIPES) == 8
    for path in RECIPES:
        cfg = load_config(path)
        assert cfg["general"]["experiment"] == "second_stage"
        assert cfg["training"]["use_adafactor"] is True
        assert not cfg["training"].get("mixed_prec_master", False)


@pytest.mark.parametrize("path", RECIPES, ids=os.path.basename)
def test_recipe_builds_with_adafactor(path, tmp_path, monkeypatch):
    """The recipe's experiment builds (nothing refused) and its optimizer is
    the factored rule over the cINN's trainable leaves, fp32.  No data is
    read: the recipes' datasets have no synthetic tree here, so the data
    module is a stub."""
    monkeypatch.setattr(ex, "StaticDataModule", lambda *a, **k: None)
    cfg = load_config(path)
    spatial = cfg["data"]["spatial_size"][0]
    names = {s: cfg[s]["name"] for s in ("first_stage", "conditioner", "poke_embedder")}
    monkeypatch.setenv("IPOKE_TPU_REGISTRY", _registry(str(tmp_path), spatial, names))
    monkeypatch.setenv("DATAPATH_BASE", str(tmp_path / "logs"))
    cfg["architecture"].update(CUT)
    recipe = str(tmp_path / os.path.basename(path))
    with open(recipe, "w") as f:
        yaml.safe_dump(cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg), f)
    args = cli.parse_args(["--config", recipe, "--model_name", "r", "--device", "cpu"])
    config, dirs, _ = cli.load_parameters(args)
    e = ex.select_experiment(config)(config, dirs, device="cpu")
    try:
        e.build()
        e.trainer.start()
    finally:
        e.metrics_logger.close()
    assert type(e) is ex.SecondStageExperiment
    assert isinstance(e.tx, Adafactor) and not e.trainer.mixed
    assert e.tx.params == e.model.flow_params.trainable()
    assert all(p.dtype == torch.float32 for p in e.tx.params)
    assert e.model.flow_in_channels == FS_ARCH["z_dim"]


def test_toy_recipe_trains_and_resumes(tmp_path, monkeypatch):
    """plants_64.yaml's training and flow sections (Adafactor, warmup over
    ``lr_scaling_max_it``) at the toy depth on the toy tree: an epoch of 2
    batches through ``main.run``, then ``--resume``: the restored Adafactor
    state equals the saved one bitwise and the run goes on to step 4."""
    env = Env(tmp_path)
    cfg = load_config(os.path.join("config", "pretrained_models", "plants_64.yaml"))
    names = {s: cfg[s]["name"] for s in ("first_stage", "conditioner", "poke_embedder")}
    monkeypatch.setenv("IPOKE_TPU_REGISTRY", _registry(
        str(tmp_path), DATA["spatial_size"][0], names, latent=4))
    # NICE hidden 16 x 8 = 128: its w2 leaves are factored; the split
    # factor of the toy second stage (8 latent channels)
    body = {"architecture": dict(cfg["architecture"], num_steps=[1, 1],
                                 flow_mid_channels_factor=16, factor=4),
            "training": dict(cfg["training"], **TRAIN)}
    for sec in names:
        body[sec] = dict(cfg[sec])
    path = env.config("second_stage", body, name="plants_64_toy")
    with open(path) as f:  # Env.config names the run dirs; keep the names
        written = yaml.safe_load(f)
    for sec in names:
        written[sec] = {"name": names[sec]}
    written["data"]["spatial_size"] = DATA["spatial_size"]
    with open(path, "w") as f:
        yaml.safe_dump(written, f)
    first = env.run(path)
    assert isinstance(first.tx, Adafactor) and first.step == 2 and first.tx.count == 2
    args = cli.parse_args(["--config", path, "--model_name", "tiny",
                           "--data_root", env.data, "--resume", "--device", "cpu"])
    monkeypatch.setenv("DATAPATH_BASE", env.base)
    config, dirs, _ = cli.load_parameters(args)
    check = ex.SecondStageExperiment(config, dirs, data_root=env.data, device="cpu")
    check.build()
    check.restore_last()
    check.metrics_logger.close()
    monkeypatch.delenv("DATAPATH_BASE")
    assert (check.step, check.tx.count, check.ddi_runs) == (2, 2, 0)
    saved, restored = first.tx.state_dict(), check.tx.state_dict()
    assert saved["count"] == restored["count"]
    for key in ("v_row", "v_col", "v"):
        for a, b in zip(saved[key], restored[key]):
            assert (a is None and b is None) or (
                a.dtype == b.dtype and torch.equal(a, b)), key
    assert any(a is not None for a in restored["v_row"])
    for a, b in zip(check.model.flow_params.parameters(),
                    first.model.flow_params.parameters()):
        assert torch.equal(a, b)
    resumed = env.run(path, "--resume")
    assert (resumed.step, resumed.tx.count, resumed.ddi_runs) == (4, 4, 0)


def test_first_stage_mixed_partial_trains_through_cli(tmp_path):
    """``training.mixed_prec`` and ``full_sequence: false`` through
    ``main.run``: the toy first stage of ``tests/test_torch_cli.py`` trains
    an epoch in bf16 over fp32 params, validates with finite metrics and
    saves fp32 weights."""
    import json

    env = Env(tmp_path)
    body = copy.deepcopy(CONFIGS["first_stage"])
    body["training"].update(mixed_prec=True, full_sequence=False)
    e = env.run(env.config("first_stage", body, name="first_stage_bf16"))
    assert e.step == 2 and not e.model.full_seq
    assert all(p.dtype == torch.float32 for p in e.model.parameters())
    assert e.model.gen.Conv2dBlock_0.Conv_0.compute_dtype == torch.bfloat16
    with open(e.metrics_logger.path) as f:
        recs = [json.loads(line) for line in f]
    assert any(k.startswith("val/") for r in recs for k in r)
    assert all(v == v and abs(v) != float("inf") for r in recs for v in r.values())
