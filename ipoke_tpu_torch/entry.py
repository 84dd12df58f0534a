"""Build the models (second stage: counterpart of
``__graft_entry__._make_models`` / ``_build``; first stage: of
``FirstStageExperiment.build``).

``SHIPPED`` is the shipped configuration (128 px, B=40, T=10, the 1054M-param
15-level cINN with NICE hidden 2048, motion encoder channels
(64,128,256,256,256)); ``SMALL`` its small variant (64 px, B=8).  ``build``
makes the model directly on a device from a ``torch.Generator``, or on
``meta`` to count parameters.  A config without ``enc_ch`` builds no motion
encoder (sampling does not run it).

Every coupling's out conv starts at g = 0, which makes every NICE and masked
conv flow an identity; ``perturb`` sets them (and the ActNorms) to
non-trivial values for runs whose outputs are compared.

``FIRST_STAGE`` is ``config/first_stage.yaml`` (64 px, B=20, T=10, fp32),
copied as the reference-style tree the first stage is built from;
``FIRST_STAGE_TINY`` is the TINY config of the JAX package's first-stage
tests; ``FC_TINY`` the FC tower at those widths, which ``build_fcae`` and
``build_second_stage_fc`` make (with ``build_first_stage`` for its first
stage); ``FC_THIRD_TINY`` adds the FC third stage over them (a flow
encoder of z_dim 6 below the residual's 8, so that the INN's input is
padded), which ``build_third_stage_fc`` makes.  ``build_first_stage`` makes
the generator, both discriminators and VGG on a device from a generator
(or on ``meta``).

``FLOW_MOTION`` is the conv third stage of ``config/flow_motion.yaml``
(the bridge INN, 64 px, B=32, T=10) over its frozen second stage, the
shipped cINN at 64 px (``bench.py``'s 64 px kwargs), and the flow VAE of
``config/flow_vae.yaml`` (``FLOW_VAE``, which also trains it: B=64), all
fp32; ``FLOW_MOTION_TINY`` is the third-stage test config of the JAX
package.  ``build_flow_motion`` makes the bridge model on a device from a
generator; ``make_batch(cfg["second_stage"], ...)`` its batches (images,
poke, flow); ``build_flow_vae`` and ``make_flow_vae_batch`` the flow VAE
and the flow maps it trains on.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .data.synthetic import make_batch as _make_batch_np
from .flows.base import ParamTree
from .models import first_stage as _fs
from .models.first_stage import FirstStageModel
from .models.second_stage import SecondStageModel
from .models.third_stage import ConvFlowVAE, FlowMotionModel
from .nn.blocks import Conv, ConvTranspose, GroupNorm
from .nn.discriminators import Dense
from .nn.encoders import FirstStageWrapper
from .nn.motion import Conv3d
from .nn.vgg import VGG19Features, load_torch_vgg19_npz

SHIPPED = dict(spatial=128, min_spatial=8, T=10, z_dim=32,
               enc_ch=(64, 128, 256, 256, 256),
               dec_ch=(256, 256, 256, 128, 64), nf_cond=64,
               num_steps=(10, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 1, 1, 1),
               mid_factor=64, batch_size=40)
SMALL = dict(spatial=64, min_spatial=8, T=10, z_dim=32,
             enc_ch=(32, 64, 128, 128), dec_ch=(128, 128, 64, 32), nf_cond=32,
             num_steps=(2, 2, 1), mid_factor=8, batch_size=8)


# config/first_stage.yaml, the parts the train step reads
FIRST_STAGE = {
    "data": {"spatial_size": (64, 64), "max_frames": 10, "batch_size": 20},
    "architecture": {
        "ENC_M_channels": [64, 128, 256, 256], "z_dim": 32, "norm": "group",
        "spectral_norm": True, "n_gru_layers": 4,
        "dec_channels": [256, 256, 128, 64], "min_spatial_size": 8,
        "motion_bias": True},
    "training": {"lr": 2e-4, "weight_decay": 1e-5,
                 "max_batches_per_epoch": 2000, "w_kl": 1e-7, "w_l1": 10.0,
                 "w_vgg": 10.0, "gamma": 0.98, "full_sequence": True},
    "d_t": {"use": True, "pretrain": 0, "max_frames": 8, "gp_weight": 1.0,
            "gen_weight": 1.0, "fmap_weight": 1.0, "layers": [1, 1, 1, 1],
            "patch_temp_disc": False},
    "d_s": {"use": True, "pretrain": 0, "n_examples": 16, "ndf": 64,
            "n_layers": 3},
}
# the TINY config of the JAX package's first-stage tests
FIRST_STAGE_TINY = {
    "data": {"spatial_size": (32, 32), "max_frames": 3, "batch_size": 2},
    "architecture": {
        "z_dim": 8, "ENC_M_channels": [16, 16, 32, 32],
        "dec_channels": [32, 32, 16, 16], "n_gru_layers": 2,
        "min_spatial_size": 4, "norm": "group", "spectral_norm": True,
        "motion_bias": True},
    "training": {"lr": 1e-3, "w_kl": 1e-6, "w_l1": 10.0, "w_vgg": 1.0,
                 "full_sequence": True},
    "d_t": {"use": True, "pretrain": 0, "max_frames": 3, "gp_weight": 1.0,
            "gen_weight": 1.0, "fmap_weight": 1.0, "layers": [1, 1, 1, 1]},
    "d_s": {"use": True, "pretrain": 0, "n_examples": 4, "ndf": 16,
            "n_layers": 2},
}


# config/flow_vae.yaml, the parts the trainer reads
FLOW_VAE = {
    "data": {"spatial_size": (64, 64), "max_frames": 10, "batch_size": 64},
    "architecture": {"flow_vae_channels": 8, "flow_vae_nf_max": 64,
                     "min_spatial_size": 8},
    "training": {"lr": 1e-3, "kl_weight": 1e-6},
}
# config/flow_motion.yaml, the parts the trainer reads (its weight decay is
# flow_adam's 1e-5, as in FlowMotionExperiment), over the shipped cINN at
# 64 px (bench.py's 64 px kwargs; fp32, as FlowMotionExperiment runs it) and
# the flow VAE of FLOW_VAE
FLOW_MOTION = {
    "second_stage": dict(SHIPPED, spatial=64, enc_ch=(64, 128, 256, 256),
                         dec_ch=(256, 256, 128, 64), batch_size=32),
    "architecture": {"num_steps": [2, 2], "flow_mid_channels_factor": 4,
                     "factor": 8, "kernel_size": [2, 3], "transform": "affine",
                     "prior_transform": "affine", "activation": "elu",
                     "flow_vae_channels": 8, "flow_vae_nf_max": 64},
    "training": {"lr": 1e-3, "n_epochs": 100,
                 "max_batches_per_epoch": 2000, "lr_scaling_max_it": 500,
                 "weight_recon": 1.0, "recon_scaling": True,
                 "spatial_mean": False},
}
# tests/test_third_stage.py's bridge (and flow VAE: 32 px, 4 channels,
# nf_max 16, min spatial 4) over tests/test_second_stage.py's SS_CFG with a
# deterministic first stage
FLOW_MOTION_TINY = {
    "second_stage": dict(spatial=32, min_spatial=4, T=3, z_dim=8,
                         enc_ch=(16, 16, 32, 32), dec_ch=(32, 32, 16, 16),
                         nf_cond=16, num_steps=(1, 1), mid_factor=2, factor=4,
                         batch_size=2, deterministic=True),
    "architecture": {"num_steps": [1], "flow_mid_channels_factor": 2,
                     "factor": 4, "flow_vae_channels": 4, "flow_vae_nf_max": 16},
    "training": {"spatial_mean": False},
}


def second_stage_config(cfg) -> dict:
    return {"architecture": {
        "flow_mid_channels_factor": cfg["mid_factor"],
        "factor": cfg.get("factor", 16),
        "num_steps": list(cfg["num_steps"]), "kernel_size": [2, 3],
        "transform": "affine", "prior_transform": "affine",
        "activation": "elu", "augmented_input": False},
        # the shipped recipe (config/second_stage.yaml): bf16-resident
        # params with fp32 masters; K4 runs in every bf16 NICE coupling
        "training": {"spatial_mean": False, "mixed_prec_master": True}}


def make_model(cfg, flow_params=None) -> SecondStageModel:
    """The model's modules (on the current default device), with
    ``flow_params`` as its flow tree if given."""
    s, m = cfg["spatial"], cfg["min_spatial"]
    fs = FirstStageModel(s, z_dim=cfg["z_dim"], dec_channels=cfg["dec_ch"],
                         n_gru_layers=2, min_spatial_size=m,
                         enc_channels=cfg.get("enc_ch"), max_frames=cfg["T"],
                         deterministic=cfg.get("deterministic", False))
    cond = FirstStageWrapper(s, nf_in=3, nf_max=cfg["nf_cond"],
                             min_spatial_size=m)
    poke = FirstStageWrapper(s, nf_in=2, nf_max=cfg["nf_cond"],
                             min_spatial_size=m)
    return SecondStageModel(second_stage_config(cfg), fs, cond, poke,
                            flow_params)


def _init_random(module: torch.nn.Module, generator) -> None:
    """Fan-in-scaled normal conv and dense weights, zero biases, unit
    GroupNorm scales, N(0, 1) motion bias and spectral-norm u, sigma 1."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, Conv3d):
                w = sub.weight
                w.normal_(0.0, w[0].numel() ** -0.5, generator=generator)
            elif isinstance(sub, (Conv, ConvTranspose)):
                w = sub.weight
                fan_in = (w.shape[1] if isinstance(sub, Conv) else w.shape[0]) \
                    * w.shape[2] * w.shape[3]
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, Dense):
                sub.kernel.normal_(0.0, sub.kernel.shape[0] ** -0.5,
                                   generator=generator)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif hasattr(sub, "init_random"):  # NormConv2d, SelfAttention
                sub.init_random(generator)
            elif isinstance(sub, GroupNorm) and sub.scale is not None:
                sub.scale.fill_(1.0)
                sub.bias.zero_()
            if getattr(sub, "snorm", False):
                sub.u.normal_(0.0, 1.0, generator=generator)
                sub.sigma.fill_(1.0)
        for name, p in module.named_parameters():
            if name.endswith("motion_bias"):
                p.normal_(0.0, 1.0, generator=generator)


def build(cfg, device,
          generator: Optional[torch.Generator] = None) -> SecondStageModel:
    """The fp32 model with random weights made on ``device`` from
    ``generator`` (``meta``: shapes only).  The flow tree follows the JAX
    package's init; the frozen nets get fan-in-scaled normal weights."""
    device = torch.device(device)
    with torch.device("meta"):
        model = make_model(cfg)
    flow_tree = model.flow.init(generator, device)
    if device.type != "meta":
        model = model.to_empty(device=device)
        _init_random(model, generator)
    model.flow_params = ParamTree(flow_tree)
    return model.eval()


def perturb(params: ParamTree, generator: torch.Generator,
            g_std: float = 0.01, b_std: float = 0.01) -> None:
    """Give every coupling's weight-norm out conv (g, b) and every ActNorm
    (log_scale, bias) of a flow's ``ParamTree`` (``model.flow_params``,
    ``model.inn_params``) random non-trivial values, in place.  The inverse
    of random couplings amplifies: at the default scales the SHIPPED depth
    (50 steps) keeps N(0, 1) inputs finite; 0.1 overflows within 5 steps."""
    def walk(node):
        if isinstance(node, dict):
            if {"v", "g", "b"} <= node.keys():
                pairs = ((node["g"], g_std), (node["b"], b_std))
            elif {"log_scale", "bias"} <= node.keys():
                pairs = ((node["log_scale"], b_std), (node["bias"], b_std))
            else:
                pairs = ()
            for t, std in pairs:
                t.copy_(std * torch.randn(t.shape, generator=generator,
                                          device=t.device))
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    with torch.no_grad():
        walk(params.tree())


def make_batch(cfg, device, dtype=torch.float32, seed: int = 0) -> dict:
    """A synthetic batch of ``cfg["batch_size"]`` clips as tensors."""
    np_batch = _make_batch_np(np.random.default_rng(seed),
                              batch_size=cfg["batch_size"], n_frames=cfg["T"],
                              spatial_size=cfg["spatial"])
    return {k: torch.as_tensor(np_batch[k], device=device, dtype=dtype)
            for k in ("images", "poke", "flow")}


def build_first_stage(cfg, device, generator: Optional[torch.Generator] = None):
    """(model, disc_s, disc_t, vgg) of the reference-style config ``cfg``
    (``FIRST_STAGE``), fp32, with random weights made on ``device`` from
    ``generator`` (``meta``: shapes only); VGG from its own CPU generator
    seeded 0, so that it has the same weights on every device (fixed-seed,
    as the JAX package's VGG; the values are not JAX's)."""
    device = torch.device(device)
    with torch.device("meta"):
        nets = _fs.build_first_stage(cfg)
    return (*(materialize(net, device, generator) for net in nets),
            build_vgg(device))


def materialize(module: torch.nn.Module, device,
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """A module built on ``meta``, moved to ``device`` with random weights
    (``_init_random``) drawn from ``generator``; on ``meta`` as it is."""
    device = torch.device(device)
    if device.type == "meta":
        return module
    module = module.to_empty(device=device)
    _init_random(module, generator)
    return module


def build_vgg(device) -> VGG19Features:
    """VGG19 to conv5_1: the converted torchvision npz that
    ``IPOKE_VGG_WEIGHTS`` names (as the JAX package's ``init_vgg_params``),
    else from its own CPU generator seeded 0, so that it has the same
    weights on every device (fixed-seed, as the JAX package's VGG; the
    values are not JAX's)."""
    device = torch.device(device)
    with torch.device("meta"):
        vgg = VGG19Features()
    if device.type == "meta":
        return vgg
    vgg = materialize(vgg, "cpu", torch.Generator().manual_seed(0))
    path = os.environ.get("IPOKE_VGG_WEIGHTS")
    if path:
        load_torch_vgg19_npz(vgg, path)
    return vgg.to(device)


# The FC tower at the widths of the JAX package's FC tests (32 px): the FC
# first stage (``FIRST_STAGE_TINY`` with the FC baseline's architecture),
# the BigAE flow encoder and the FC encoders and second stage over them
FC_TINY = {
    "first_stage": dict(FIRST_STAGE_TINY, architecture={
        "fc_baseline": True, "z_dim": 8, "ENC_M_channels": [16, 16, 32, 32],
        "dec_channels": [32, 32, 16, 16], "n_gru_layers": 2, "CN_content": "spade"}),
    "flow_encoder": {
        "data": {"spatial_size": (32, 32), "batch_size": 2},
        "architecture": {"z_dim": 10, "n_out_channels": 2, "gen_ch": 8},
        "training": {"lr": 1e-3, "perc_weight": 1.0, "kl_weight": 1e-3,
                     "disc_weight": 1.0},
        "disc": {"ndf": 8, "n_layers": 2}},
    "encoders": {"nf_max": 16},
    "second_stage": {
        "architecture": {"flow_mid_channels_factor": 2, "flow_hidden_depth": 2,
                         "n_flows": 3},
        "training": {"lr": 1e-3, "base_distribution": "gaussian"}},
}


def build_fcae(cfg, device, generator: Optional[torch.Generator] = None):
    """(BigAE, discriminator, VGG) of a ``flow_encoder_fc`` config
    (``FC_TINY["flow_encoder"]``), fp32, with random weights made on
    ``device`` from ``generator``."""
    from .models.fc_stack import build_big_ae
    from .nn.discriminators import PatchDiscriminator2D

    dcfg = cfg.get("disc", {})
    with torch.device("meta"):
        model = build_big_ae(cfg)
        disc = PatchDiscriminator2D(dcfg.get("ndf", 64), dcfg.get("n_layers", 3),
                                    cin=model.in_channels)
    return (materialize(model, device, generator), materialize(disc, device, generator),
            build_vgg(device))


def build_second_stage_fc(cfg, device, generator: Optional[torch.Generator] = None):
    """The fp32 ``SecondStageModelFC`` of ``FC_TINY``-style ``cfg`` over a
    random FC first stage (``cfg["first_stage"]``) and conditioner and poke
    embedder (``nf_max`` of ``cfg["encoders"]``), frozen: spectral norms
    collapsed, eval, no grad."""
    from .models.fc_baseline import FirstStageFCWrapper, SecondStageModelFC
    from .models.image_ae import freeze_spectral_norm

    fs_cfg = cfg["first_stage"]
    s, nf = fs_cfg["data"]["spatial_size"][0], cfg["encoders"]["nf_max"]
    with torch.device("meta"):
        nets = (_fs.build_first_stage(fs_cfg)[0], FirstStageFCWrapper(s, 3, nf),
                FirstStageFCWrapper(s, 2, nf))
    nets = [freeze_spectral_norm(materialize(n, "cpu", generator)).eval().requires_grad_(False)
            for n in nets]
    model = SecondStageModelFC(cfg["second_stage"], *nets)
    model.flow_params = ParamTree(model.flow.init(generator, "cpu"))
    return model.to(device)


# FC_TINY with the FC third stage over it
FC_THIRD_TINY = dict(
    FC_TINY,
    flow_encoder=dict(FC_TINY["flow_encoder"], architecture=dict(
        FC_TINY["flow_encoder"]["architecture"], z_dim=6)),
    third_stage={
        "architecture": {"flow_mid_channels_factor": 2, "flow_hidden_depth": 2,
                         "n_flows": 3},
        "training": {"lr": 1e-3}})


def build_third_stage_fc(cfg, device, generator: Optional[torch.Generator] = None,
                         conditional: bool = False):
    """The fp32 ``ThirdStageFC`` of ``FC_THIRD_TINY``-style ``cfg`` over
    ``build_second_stage_fc(cfg)`` and a random frozen BigAE
    (``cfg["flow_encoder"]``), its INN fresh (Glorot couplings, identity
    ActNorms), conditioned on the poke embedding when ``conditional``."""
    from .models.fc_stack import build_big_ae
    from .models.image_ae import freeze_spectral_norm
    from .models.third_stage import ThirdStageFC

    ss = build_second_stage_fc(cfg, "cpu", generator)
    with torch.device("meta"):
        fe = build_big_ae(cfg["flow_encoder"])
    fe = freeze_spectral_norm(materialize(fe, "cpu", generator)).eval().requires_grad_(False)
    ts = cfg["third_stage"]
    ts = dict(ts, architecture=dict(ts["architecture"], flow_in_channels=ss.flow_in_channels))
    model = ThirdStageFC(ts, fe, ss, ss.poke_embedder.nf_max if conditional else 0)
    model.inn_params = ParamTree(model.init(generator, "cpu"))
    return model.to(device)


def make_first_stage_batch(cfg, device, seed: int = 0) -> dict:
    """A synthetic batch of clips (B, T+1, H, W, 3) in [-1, 1] at ``cfg``'s
    data sizes, as a dict with ``images``."""
    d = cfg["data"]
    np_batch = _make_batch_np(np.random.default_rng(seed),
                              batch_size=d["batch_size"], n_frames=d["max_frames"],
                              spatial_size=d["spatial_size"][0])
    return {"images": torch.as_tensor(np_batch["images"], device=device)}


def build_flow_vae(spatial: int, arch, min_spatial: int, device,
                   generator: Optional[torch.Generator] = None) -> ConvFlowVAE:
    """The fp32 ``ConvFlowVAE`` of an ``architecture`` block, with random
    weights made on ``device`` from ``generator`` (``meta``: shapes only)."""
    device = torch.device(device)
    with torch.device("meta"):
        vae = ConvFlowVAE(spatial, arch.get("flow_vae_channels", 8),
                          arch.get("flow_vae_nf_max", 64), min_spatial)
    if device.type != "meta":
        vae = vae.to_empty(device=device)
        _init_random(vae, generator)
    return vae


def build_flow_motion(cfg, device,
                      generator: Optional[torch.Generator] = None) -> FlowMotionModel:
    """The fp32 bridge model of ``cfg`` (``FLOW_MOTION``): the frozen second
    stage (``build``), the frozen flow VAE and a new bridge tree, all with
    random weights made on ``device`` from ``generator`` (``meta``: shapes
    only).  Every bridge coupling is an identity until ``perturb``."""
    ss_cfg = cfg["second_stage"]
    second_stage = build(ss_cfg, device, generator)
    vae = build_flow_vae(ss_cfg["spatial"], cfg["architecture"],
                         ss_cfg["min_spatial"], device, generator)
    model = FlowMotionModel(cfg, second_stage, vae)
    model.inn_params = ParamTree(model.init(generator, torch.device(device)))
    return model.eval()


def make_flow_vae_batch(cfg, device, seed: int = 0) -> dict:
    """A synthetic batch of flow maps (B, H, W, 2) at ``cfg``'s data sizes
    (``FLOW_VAE``), as a dict with ``flow``."""
    d = cfg["data"]
    np_batch = _make_batch_np(np.random.default_rng(seed),
                              batch_size=d["batch_size"], n_frames=d["max_frames"],
                              spatial_size=d["spatial_size"][0])
    return {"flow": torch.as_tensor(np_batch["flow"], device=device)}
