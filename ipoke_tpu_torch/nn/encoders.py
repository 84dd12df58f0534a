"""Conv encoder and decoders (counterpart of ``ipoke_tpu/nn/encoders.py``),
NHWC.  ``ConvEncoder`` is deterministic, or with ``variational`` adds the
``NormConv2d`` mean and sigmoid log-std heads, its sample's noise given as
a tensor (``models.image_ae.ImageAEStep.noise`` draws it).  ``ConvEncoder`` defaults to flax's spectral norm in its
convs and ``ConvDecoder`` always has it in its ResBlocks, as in the JAX
package (the flow VAE trains them so); the frozen ``FirstStageWrapper`` builds its encoder
without it and takes the collapsed weights (``convert``).  The SPADE
decoder also trains (first stage), with spectral norm in its conv blocks."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .blocks import Conv2dBlock, NormConv2d, ResBlock, Spade


class ConvEncoder(nn.Module):
    """Strided Conv2dBlock stem, stride-2 ResBlocks, bottleneck ResBlock;
    ``snorm``: spectral norm in the stem and every ResBlock conv.
    ``depths``: the per-stage widths, shallowest last (the ``ConvDecoder``
    input spec).  ``variational``: the mean and log-std heads, 3x3
    ``NormConv2d`` each, the log-std squashed by a sigmoid."""

    def __init__(self, nf_in: int, nf_max: int, n_stages: int,
                 snorm: bool = True, variational: bool = False):
        super().__init__()
        self.variational = variational
        nf = 32
        sn = dict(norm="group", activation="elu", snorm=snorm)
        self.Conv2dBlock_0 = Conv2dBlock(nf_in, nf, 3, 2, 1, **sn)
        depths = [nf]
        for i in range(n_stages - 1):
            nf_next = min(nf * 2, nf_max)
            self.add_module(f"ResBlock_{i}", ResBlock(nf, nf_next, stride=2, **sn))
            nf = nf_next
            depths.insert(0, nf)
        self.n_res, self.depths = n_stages, tuple(depths)
        self.add_module(f"ResBlock_{n_stages - 1}", ResBlock(nf, nf_max, **sn))
        if variational:
            self.NormConv2d_0 = NormConv2d(nf_max, nf_max, 3, padding=1)
            self.NormConv2d_1 = NormConv2d(nf_max, nf_max, 3, padding=1)

    def forward(self, x, train: bool = False, noise: Optional[torch.Tensor] = None):
        """(h, mean_pre, None) when deterministic, as the JAX encoder
        returns; else (z, mean, logstd) with z = mean + exp(logstd) * noise
        (z = mean without ``noise``).  ``train`` stores each spectral norm's
        new u and sigma."""
        h = self.Conv2dBlock_0(x, train)
        for i in range(self.n_res - 1):
            h = getattr(self, f"ResBlock_{i}")(h, train)
        mean_pre = h
        h = getattr(self, f"ResBlock_{self.n_res - 1}")(h, train)
        if not self.variational:
            return h, mean_pre, None
        mean = self.NormConv2d_0(h)
        logstd = torch.sigmoid(self.NormConv2d_1(h))
        if noise is None:
            return mean, mean, logstd
        return noise.to(mean.dtype) * torch.exp(logstd) + mean, mean, logstd


class ConvDecoder(nn.Module):
    """A ResBlock, then upsampling ResBlocks, then a Conv2dBlock to
    ``out_channels`` (tanh at 3, else no activation).  ``in_channels`` is the
    channel plan, deepest first (``[nf_max] + encoder.depths``); group norm
    and spectral norm in every ResBlock conv (not the output conv).  The
    flow VAE's decoder has 2 outputs; the image AE's has its input's
    channels."""

    def __init__(self, nf_in: int, in_channels: Sequence[int],
                 out_channels: int = 2):
        super().__init__()
        self.ResBlock_0 = ResBlock(nf_in, in_channels[0], snorm=True)
        self.n_up = len(in_channels) - 1
        for i, (cin, nf) in enumerate(zip(in_channels[:-1], in_channels[1:])):
            self.add_module(f"ResBlock_{i + 1}", ResBlock(
                cin, nf, upsampling=True, snorm=True))
        self.Conv2dBlock_0 = Conv2dBlock(
            in_channels[-1], out_channels, 3, 1, 1, norm="none",
            activation="tanh" if out_channels == 3 else "none")

    def forward(self, z, train: bool = False):
        h = self.ResBlock_0(z, train)
        for i in range(self.n_up):
            h = getattr(self, f"ResBlock_{i + 1}")(h, train)
        return self.Conv2dBlock_0(h)


class SpadeCondConvDecoder(nn.Module):
    """Upsampling decoder with SPADE(start_frame) after every ResBlock;
    ``snorm``: spectral norm in every ResBlock conv (not in the SPADE and
    output convs, as in the JAX package).  ``torch_compat``: the reference's
    semantics for its ported weights, the up blocks' transpose convs cropped
    as torch's (with its elu -> ReLU) and the SPADE resize with
    ``align_corners``."""

    def __init__(self, nf_in: int, dec_channels: Sequence[int],
                 out_channels: int = 3, norm: str = "group", snorm: bool = False,
                 torch_compat: bool = False):
        super().__init__()
        self.ResBlock_0 = ResBlock(nf_in, dec_channels[0], norm=norm, snorm=snorm)
        self.n_up = len(dec_channels) - 1
        for i, (cin, nf) in enumerate(zip(dec_channels[:-1], dec_channels[1:])):
            self.add_module(f"ResBlock_{i + 1}", ResBlock(
                cin, nf, norm="none", upsampling=True, snorm=snorm,
                torch_crop=torch_compat))
            self.add_module(f"Spade_{i}", Spade(nf, align_corners=torch_compat))
        self.Conv2dBlock_0 = Conv2dBlock(
            dec_channels[-1], out_channels, 3, 1, 1, norm="none",
            activation="tanh" if out_channels == 3 else "none")

    def spade_modulations(self, start_frame, in_size: int):
        """Per-level SPADE (gamma, beta) from the start frame alone."""
        mods, size = [], in_size
        for i in range(self.n_up):
            size *= 2
            mods.append(getattr(self, f"Spade_{i}").modulation(
                start_frame, size, size))
        return tuple(mods)

    def forward(self, h_t, mods, train: bool = False):
        h = self.ResBlock_0(h_t, train)
        for i in range(self.n_up):
            h = getattr(self, f"ResBlock_{i + 1}")(h, train)
            h = getattr(self, f"Spade_{i}")(h, mods[i])
        return self.Conv2dBlock_0(h)


class FirstStageWrapper(nn.Module):
    """The conv AE of the image conditioner and the poke embedder,
    deterministic or (``deterministic=False``) variational; with
    ``poke_and_image`` its encoder also takes the start frame (3 more input
    channels).  With ``decoder`` it is the trainable AE of the image AE
    stage: encoder and decoder, with flax's spectral norm in the stem and
    every ResBlock conv (the CLI's frozen copies are that net with its
    spectral norms collapsed, ``models.image_ae.freeze_spectral_norm``).
    Without it, the frozen encoder alone that ``entry``'s sampling models
    build for converted weights (``convert``).  ``latent_shape``: one
    sample's latent (the shape of the encoder's noise)."""

    def __init__(self, spatial_size: int, nf_in: int, nf_max: int,
                 min_spatial_size: int = 8, decoder: bool = False,
                 deterministic: bool = True, poke_and_image: bool = False):
        super().__init__()
        self.nf_max, self.min_spatial_size = nf_max, min_spatial_size
        self.deterministic, self.poke_and_image = deterministic, poke_and_image
        self.latent_shape = (min_spatial_size, min_spatial_size, nf_max)
        n_stages = int(np.log2(spatial_size // min_spatial_size))
        self.encoder = ConvEncoder(nf_in + (3 if poke_and_image else 0), nf_max,
                                   n_stages, snorm=decoder,
                                   variational=not deterministic)
        if decoder:
            self.decoder = ConvDecoder(nf_max, (nf_max,) + self.encoder.depths,
                                       out_channels=nf_in)

    def encode(self, x, train: bool = False, noise: Optional[torch.Tensor] = None):
        return self.encoder(x, train, noise)

    def forward(self, x, train: bool = False, noise: Optional[torch.Tensor] = None):
        """The reconstruction of ``x`` (of the sample ``noise`` gives, for a
        variational AE; of the mean without it); ``train`` advances every
        spectral norm's u."""
        z, _, _ = self.encoder(x, train, noise)
        return self.decoder(z, train)
