"""Conv third stage (counterpart of ``ipoke_tpu/models/third_stage.py``, the
conv half): predict the second stage's residual from encoded optical flow,
so that flow can be hallucinated rather than measured.

``ConvFlowVAE`` encodes a flow map (B, H, W, 2) to a spatial latent; the
bridge ``FlowMotionModel.inn``, an unconditioned multi-scale MaCow INN, maps
``[flow latent, N(0, I) channels]`` onto the frozen conv second stage's
residual space.  Loss = flow NLL + weight_recon * smooth-L1(out, the second
stage's ``forward_density``).  Composed: flow -> flow-VAE encode -> bridge
-> residual -> second-stage inverse -> first-stage decode, video from flow
with no measured motion latent.

Every random draw is the caller's: a ``torch.Generator`` or explicit noise
tensors (the JAX package draws from its keys inside the same functions).
The bridge's unit inverses run K2 without conditioning rows; its NICE
couplings run fp32, outside K1's bf16 family, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..flows import MultiScaleInternal, ParamTree, flow_loss
from ..nn.blocks import Conv
from ..nn.encoders import ConvDecoder, ConvEncoder
from .second_stage import SecondStageModel


def _randn(shape, generator, like):
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


class ConvFlowVAE(nn.Module):
    """Conv VAE over flow maps -> spatial latent (reference
    ``models/opticalFlow/models.py`` FlowVAE/FlowVAE3).  Encoder and
    decoder carry flax's spectral norm in their ResBlock convs."""

    def __init__(self, spatial_size: int, bottleneck_channels: int = 8,
                 nf_max: int = 128, min_spatial_size: int = 8):
        super().__init__()
        n_stages = int(np.log2(spatial_size // min_spatial_size))
        self.bottleneck_channels = bottleneck_channels
        self.encoder = ConvEncoder(2, nf_max, n_stages)
        self.to_mu = Conv(nf_max, bottleneck_channels, 3, 1, 1)
        self.to_logvar = Conv(nf_max, bottleneck_channels, 3, 1, 1)
        self.from_z = Conv(bottleneck_channels, nf_max, 3, 1, 1)
        self.decoder = ConvDecoder(nf_max, (nf_max,) + self.encoder.depths)

    def encode(self, x, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, train: bool = False):
        """(z, mu, logvar), logvar clipped to [-30, 20]; z = mu +
        exp(logvar / 2) * noise, the noise given or drawn from
        ``generator``; z = mu with neither."""
        h, _, _ = self.encoder(x, train)
        mu = self.to_mu(h)
        logvar = torch.clamp(self.to_logvar(h), -30.0, 20.0)
        if noise is None and generator is not None:
            noise = _randn(mu.shape, generator, mu)
        if noise is None:
            return mu, mu, logvar
        return mu + torch.exp(0.5 * logvar) * noise, mu, logvar

    def decode(self, z, train: bool = False):
        return self.decoder(self.from_z(z), train)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, train: bool = False):
        """(reconstruction, mu, logvar); ``train`` stores every spectral
        norm's new u and sigma (flax's ``mutable=["batch_stats"]``)."""
        z, mu, logvar = self.encode(x, generator, noise, train)
        return self.decode(z, train), mu, logvar


def smooth_l1(a, b):
    """Mean smooth-L1 (Huber) distance, beta 1."""
    return F.smooth_l1_loss(a, b)


@dataclasses.dataclass
class ThirdStageState:
    """The trainer's state: the optimizer over the bridge's params (which
    live in ``FlowMotionModel.inn_params``), the updates made and the recon
    weight."""

    tx: object
    step: int
    weight_recon: float


def create_third_stage_state(model: "FlowMotionModel", make_tx: Callable,
                             weight_recon: float = 1.0) -> ThirdStageState:
    """Freeze every net but the bridge; ``make_tx`` builds the optimizer
    over the bridge's trainable leaves."""
    model.requires_grad_(False)
    return ThirdStageState(make_tx(model.inn_params.trainable()), 0,
                           float(weight_recon))


def double_recon_weight_schedule(state: ThirdStageState, epoch: int,
                                 initial: float) -> ThirdStageState:
    """x2 at the start of every epoch with ``epoch % 10 == 9``:
    ``initial * 2 ** ((epoch + 1) // 10)``, a pure function of the epoch,
    so calling it once per batch does not compound."""
    return dataclasses.replace(
        state, weight_recon=float(initial * 2.0 ** ((epoch + 1) // 10)))


class FlowMotionModel(nn.Module):
    """The bridge INN over a frozen conv ``SecondStageModel`` and a frozen
    ``ConvFlowVAE``.  ``inn`` is the static flow description,
    ``inn_params`` its parameter tree (the JAX package's ``params["inn"]``)."""

    def __init__(self, config, second_stage: SecondStageModel,
                 flow_vae: ConvFlowVAE, inn_params=None):
        super().__init__()
        self.config = config
        self.second_stage = second_stage
        self.flow_vae = flow_vae
        arch = config["architecture"]
        self.z_total = second_stage.flow_in_channels
        self.z_flow = flow_vae.bottleneck_channels
        if self.z_total < self.z_flow:
            raise ValueError(f"flow latent {self.z_flow} channels > the "
                             f"residual's {self.z_total}")
        self.inn = MultiScaleInternal(
            num_steps=tuple(arch.get("num_steps", (2, 2))),
            in_channels=self.z_total,
            hidden_channels=int(arch.get("flow_mid_channels_factor", 4)
                                * self.z_total),
            h_channels=0,
            factor=int(arch.get("factor", 8)),
            transform=arch.get("transform", "affine"),
            prior_transform=arch.get("prior_transform", "affine"),
            kernel_size=tuple(arch.get("kernel_size", (2, 3))),
            activation=arch.get("activation", "elu"),
        )
        self.s = second_stage.min_spatial_size
        self.inn_params = ParamTree(inn_params) if inn_params is not None \
            else None

    def init(self, generator, device):
        """A new bridge tree (every out conv at g = 0: identities)."""
        return self.inn.init(generator, device)

    @torch.no_grad()
    def make_flow_input(self, batch, generator: Optional[torch.Generator] = None,
                        noise=None, reverse: bool = False):
        """Forward: [the flow VAE's sample of ``batch["flow"]``, N(0, I)
        channels up to the residual's width]; ``noise`` is the pair (the
        VAE's eps, the extra channels), else both are drawn from
        ``generator``.  Reverse: z (B, s, s, z_total) ~ N(0, I), ``noise``
        itself if given.  Outside autograd (the JAX package's
        stop-gradient: the frozen VAE gets no gradient)."""
        x = batch["images"]
        if reverse:
            if noise is not None:
                return noise
            return _randn((x.shape[0], self.s, self.s, self.z_total),
                          generator, x)
        eps, extra = (None, None) if noise is None else noise
        z, _, _ = self.flow_vae.encode(batch["flow"], generator, eps)
        if extra is None:
            extra = _randn((*z.shape[:-1], self.z_total - self.z_flow),
                           generator, z)
        return torch.cat([z, extra], dim=-1)

    def forward_density(self, batch, generator: Optional[torch.Generator] = None,
                        noise=None):
        """(out, logdet) of the bridge on the batch's encoded flow."""
        flow_input = self.make_flow_input(batch, generator, noise)
        return self.inn.forward(self.inn_params.tree(), flow_input, None)

    @torch.no_grad()
    def forward_sample_flow(self, batch, generator: Optional[torch.Generator] = None,
                            z: Optional[torch.Tensor] = None):
        """z ~ N(0, I) (or the given ``z``) -> bridge inverse -> flow-VAE
        decode of the first ``z_flow`` channels: hallucinated flow (B, H,
        W, 2)."""
        z = self.make_flow_input(batch, generator, z, reverse=True)
        out = self.inn.inverse(self.inn_params.tree(), z, None)
        return self.flow_vae.decode(out[..., :self.z_flow])

    @torch.no_grad()
    def forward_video_from_flow(self, batch, length: int,
                                generator: Optional[torch.Generator] = None,
                                noise=None):
        """Flow -> flow-VAE encode -> bridge forward -> residual -> the
        second stage's inverse and first-stage decode (its
        ``forward_sample`` from that residual): video (B, T, H, W, 3)."""
        residual, _ = self.forward_density(batch, generator, noise)
        return self.second_stage.forward_sample(batch, length, z=residual)


def make_flow_motion_train_step(model: FlowMotionModel) -> Callable:
    """``step(state, batch, generator=None, noise=None) -> (state, log)``:
    the frozen second stage's ``forward_density`` as the target (no grad),
    the bridge forward under autograd, flow NLL + ``state.weight_recon`` *
    smooth-L1, backward, one step of ``state.tx``.  ``noise`` is the triple
    (the VAE's eps, the extra channels, the ``reference_nll_loss``
    diagnostic's sample), else all are drawn from ``generator``, which also
    draws the second stage's motion sample."""
    spatial_mean = bool(model.config["training"].get("spatial_mean", False))

    def step(state: ThirdStageState, batch,
             generator: Optional[torch.Generator] = None, noise=None):
        eps, extra, reference = (None,) * 3 if noise is None else noise
        with torch.no_grad():
            target, _ = model.second_stage.forward_density(batch, generator)
        out, logdet = model.forward_density(batch, generator, (eps, extra))
        loss, log = flow_loss(out, logdet, generator=generator,
                              spatial_mean=spatial_mean, reference=reference)
        recon = smooth_l1(out, target)
        log["reconstruction_loss"] = recon
        loss = loss + state.weight_recon * recon
        log["flow_loss"] = loss
        loss.backward()
        state.tx.step()
        return (dataclasses.replace(state, step=state.step + 1),
                {k: v.detach() for k, v in log.items()})

    return step
