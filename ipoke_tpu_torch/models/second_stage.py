"""Second-stage conditional INN (counterpart of
``ipoke_tpu/models/second_stage.py``): a multi-scale MaCow cINN maps the
frozen first stage's motion latent to z ~ N(0, I) (the density direction that
training fits by NLL) and back (sampling), conditioned on
``h = [phi(x_0), phi(poke)]`` from the frozen conditioner and poke embedder;
the first stage decodes a sampled latent to video.

With ``architecture.augmented_input`` the flow's input is the motion latent
and ``augment_channels`` more: ``scale_augment * N(0, 1) + shift_augment``
per channel, drawn for each density pass and DDI and dropped after the
sampling inverse.  ``flow_params`` then holds the JAX package's whole
second-stage tree, ``{"flow": ..., "scale_augment": ones, "shift_augment":
zeros}`` (``init_params``); otherwise the flow's tree alone."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..core.optim import cast_floats
from ..flows import ParamTree, build_macow_transformer, flow_loss
from ..nn.encoders import FirstStageWrapper
from .first_stage import FirstStageModel


class SecondStageModel(nn.Module):
    """``flow`` is the static cINN description, ``flow_params`` its parameter
    tree; the three frozen nets are submodules.  ``config`` carries the
    ``architecture`` block and, for training, the ``training`` block."""

    def __init__(self, config, first_stage: FirstStageModel,
                 conditioner: FirstStageWrapper,
                 poke_embedder: FirstStageWrapper, flow_params=None):
        super().__init__()
        self.config = config
        arch = config["architecture"]
        self.first_stage = first_stage
        self.conditioner = conditioner
        self.poke_embedder = poke_embedder
        for size, name in ((poke_embedder.min_spatial_size, "poke embedder"),
                           (conditioner.min_spatial_size, "conditioner")):
            if size != first_stage.min_spatial_size:
                raise NotImplementedError(
                    f"conv_adapt ({name} latent {size} vs first stage "
                    f"{first_stage.min_spatial_size}) is not ported yet")
        self.augment_channels = int(arch.get("augment_channels", 0)) \
            if arch.get("augmented_input", False) else 0
        flow_in = first_stage.z_dim + self.augment_channels
        h_channels = poke_embedder.nf_max + conditioner.nf_max
        self.flow = build_macow_transformer(dict(
            arch, flow_in_channels=flow_in, h_channels=h_channels,
            flow_mid_channels=int(arch.get("flow_mid_channels_factor", 8)
                                  * flow_in)))
        self.flow_in_channels = flow_in
        self.min_spatial_size = first_stage.min_spatial_size
        self.flow_params = ParamTree(flow_params) if flow_params is not None \
            else None

    def init_params(self, generator, device):
        """A new second-stage tree: the flow's init, and the augmentation's
        scale (ones) and shift (zeros) with ``augmented_input``."""
        tree = self.flow.init(generator, device)
        if not self.augment_channels:
            return tree
        c = self.augment_channels
        return {"flow": tree, "scale_augment": torch.ones(c, device=device),
                "shift_augment": torch.zeros(c, device=device)}

    def flow_tree(self):
        """The flow's parameter tree (inside ``flow_params``)."""
        tree = self.flow_params.tree()
        return tree["flow"] if self.augment_channels else tree

    def augment(self, motion, generator=None, noise=None):
        """``motion`` with the augmentation channels appended: ``noise``
        (B, s, s, augment_channels), or N(0, 1) drawn from ``generator``,
        scaled and shifted by the trainable per-channel params."""
        if not self.augment_channels:
            return motion
        if noise is None:
            noise = torch.randn((*motion.shape[:-1], self.augment_channels),
                                generator=generator, device=motion.device,
                                dtype=motion.dtype)
        tree = self.flow_params.tree()
        aug = tree["scale_augment"] * noise.to(motion.dtype) + tree["shift_augment"]
        return torch.cat([motion, aug], dim=-1)

    def embed_conditioning(self, batch):
        """h = [phi(x_0), phi(poke)] (B, s, s, Ch)."""
        poke_emb, _, _ = self.poke_embedder.encode(batch["poke"])
        cond, _, _ = self.conditioner.encode(batch["images"][:, 0])
        return torch.cat([cond, poke_emb], dim=-1)

    def encode_first_stage(self, X, generator: Optional[torch.Generator] = None):
        """The motion latent of the clip ``X``: a sample drawn from
        ``generator`` (mu without one, or when deterministic)."""
        motion, _, _ = self.first_stage.encode(X, generator)
        return motion

    def _flow_input(self, batch, generator):
        """(motion, h) from the frozen nets, outside autograd: the
        stop-gradient of the JAX package, which differentiates the flow
        params only."""
        with torch.no_grad():
            cond = self.embed_conditioning(batch)
            motion = self.encode_first_stage(batch["images"], generator)
        # a first stage trained under mixed_prec computes in bf16: the flow
        # takes its input in its params' dtype, as JAX promotes it
        dtype = next(self.flow_params.parameters()).dtype
        return motion.to(dtype), cond.to(dtype)

    def forward_density(self, batch, generator: Optional[torch.Generator] = None,
                        aug_noise: Optional[torch.Tensor] = None):
        """(z, logdet) of the batch's motion latent for NLL training; the
        augmentation's noise (``augmented_input``) is ``aug_noise`` or drawn
        from ``generator`` after the motion sample."""
        motion, cond = self._flow_input(batch, generator)
        x = self.augment(motion, generator, aug_noise)
        return self.flow.forward(self.flow_tree(), x, cond)

    @torch.no_grad()
    def ddi(self, batch, generator: Optional[torch.Generator] = None,
            aug_noise: Optional[torch.Tensor] = None):
        """Data-dependent init of the flow from one batch: the new
        ``flow_params`` tree (``flow_params.load_tree`` takes it in)."""
        motion, cond = self._flow_input(batch, generator)
        x = self.augment(motion, generator, aug_noise)
        new = self.flow.ddi(self.flow_tree(), x, cond)[2]
        if not self.augment_channels:
            return new
        return dict(self.flow_params.tree(), flow=new)

    @torch.no_grad()
    def forward_sample(self, batch, length: int,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None):
        """Sample videos (B, T, H, W, 3): z ~ N(0, I) (or the given ``z``),
        the cINN inverse, then the first-stage decode.  z and the work run in
        the dtype of ``batch["images"]``."""
        x = batch["images"]
        s = self.min_spatial_size
        cond = self.embed_conditioning(batch)
        if z is None:
            z = torch.randn((x.shape[0], s, s, self.flow_in_channels),
                            generator=generator, device=x.device,
                            dtype=x.dtype)
        motion = self.flow.inverse(self.flow_tree(), z, cond)
        motion = motion[..., :self.first_stage.z_dim]
        return self.first_stage.decode(motion, x[:, 0], length)


def create_second_stage_state(model: SecondStageModel, make_tx: Callable):
    """The optimizer over the flow's trainable leaves (which it switches to
    ``requires_grad``); the frozen nets stay frozen.  The port's train state
    is the model's own params plus this optimizer."""
    model.requires_grad_(False)
    return make_tx(model.flow_params.trainable())


def make_second_stage_train_step(model: SecondStageModel, tx) -> Callable:
    """``step(batch, generator=None) -> log``: density forward, NLL, backward,
    one optimizer step.  Under ``training.mixed_prec_master`` the batch is
    cast to bf16 to match the bf16-resident params; the loss and logdet
    reductions are fp32.  ``generator`` draws the motion sample and the
    ``reference_nll_loss`` diagnostic's sample."""
    tcfg = model.config.get("training", {})
    spatial_mean = bool(tcfg.get("spatial_mean", False))
    mixed = bool(tcfg.get("mixed_prec_master", False))
    radial = bool(getattr(model, "radial", False))  # the FC second stage's option

    def step(batch, generator: Optional[torch.Generator] = None):
        if mixed:
            batch = cast_floats(batch, torch.bfloat16)
        z, logdet = model.forward_density(batch, generator)
        loss, log = flow_loss(z, logdet, generator=generator,
                              spatial_mean=spatial_mean, radial=radial)
        loss.backward()
        tx.step()
        return {k: v.detach() for k, v in log.items()}

    return step
