"""Build the second-stage model (counterpart of
``__graft_entry__._make_models`` / ``_build``).

``SHIPPED`` is the shipped configuration (128 px, B=40, T=10, the 1054M-param
15-level cINN with NICE hidden 2048, motion encoder channels
(64,128,256,256,256)); ``SMALL`` its small variant (64 px, B=8).  ``build``
makes the model directly on a device from a ``torch.Generator``, or on
``meta`` to count parameters.  A config without ``enc_ch`` builds no motion
encoder (sampling does not run it).

Every coupling's out conv starts at g = 0, which makes every NICE and masked
conv flow an identity; ``perturb`` sets them (and the ActNorms) to
non-trivial values for runs whose outputs are compared.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .data.synthetic import make_batch as _make_batch_np
from .flows.base import ParamTree
from .models.first_stage import FirstStageModel
from .models.second_stage import SecondStageModel
from .nn.blocks import Conv, ConvTranspose, GroupNorm
from .nn.encoders import FirstStageWrapper
from .nn.motion import Conv3d

SHIPPED = dict(spatial=128, min_spatial=8, T=10, z_dim=32,
               enc_ch=(64, 128, 256, 256, 256),
               dec_ch=(256, 256, 256, 128, 64), nf_cond=64,
               num_steps=(10, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 1, 1, 1),
               mid_factor=64, batch_size=40)
SMALL = dict(spatial=64, min_spatial=8, T=10, z_dim=32,
             enc_ch=(32, 64, 128, 128), dec_ch=(128, 128, 64, 32), nf_cond=32,
             num_steps=(2, 2, 1), mid_factor=8, batch_size=8)


def second_stage_config(cfg) -> dict:
    return {"architecture": {
        "flow_mid_channels_factor": cfg["mid_factor"], "factor": 16,
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


def _init_frozen(module: torch.nn.Module, generator) -> None:
    """Fan-in-scaled normal conv weights, zero biases, unit GroupNorm scales,
    N(0, 1) motion bias."""
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
                sub.bias.zero_()
            elif isinstance(sub, GroupNorm) and sub.scale is not None:
                sub.scale.fill_(1.0)
                sub.bias.zero_()
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
        _init_frozen(model, generator)
    model.flow_params = ParamTree(flow_tree)
    return model.eval()


def perturb(model: SecondStageModel, generator: torch.Generator,
            g_std: float = 0.01, b_std: float = 0.01) -> None:
    """Give every coupling's weight-norm out conv (g, b) and every ActNorm
    (log_scale, bias) random non-trivial values, in place.  The inverse of
    random couplings amplifies: at the default scales the SHIPPED depth
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
        walk(model.flow_params.tree())


def make_batch(cfg, device, dtype=torch.float32, seed: int = 0) -> dict:
    """A synthetic batch of ``cfg["batch_size"]`` clips as tensors."""
    np_batch = _make_batch_np(np.random.default_rng(seed),
                              batch_size=cfg["batch_size"], n_frames=cfg["T"],
                              spatial_size=cfg["spatial"])
    return {k: torch.as_tensor(np_batch[k], device=device, dtype=dtype)
            for k in ("images", "poke", "flow")}

