"""The FC (vector-latent) baseline tower (counterpart of
``ipoke_tpu/models/fc_baseline.py``), NHWC:

* ``BaselineFCEncoder`` / ``BaselineFCGenerator`` / ``FirstStageFCWrapper``:
  a conv encoder to 4x4, then a valid 4x4 ``NormConv2d`` to a vector
  latent; the generator a Dense to 4x4, then upsampling ResBlocks (flax's
  spectral norm in every conv) with optional SPADE on the start frame.
  The FC image and poke encoders train the wrapper as the image AE stage
  (``models.image_ae``);
* ``FCBaselineModel``: the FC first stage, a 3D-ResNet motion encoder with
  4x4 valid heads to a vector z, a dense GRU rollout and the SPADE
  generator; it trains under the conv first stage's ``FirstStageStep``;
* ``SecondStageModelFC``: the flat coupling cINN over that vector latent,
  conditioned on the FC conditioner's and poke embedder's vectors, with the
  second stage's interface (``forward_density``, ``forward_sample``,
  ``ddi``), so that ``train.SecondStageTrainer`` and the ``--test`` modes
  take it as they take the conv one.

``GRUCell`` is flax's ``nn.GRUCell``, not torch's: biases on the input
gates ``ir``, ``iz``, ``in`` and on ``hn`` only.

The generator's eval decode renders the B*T frames of a clip batch in one
call, with the SPADE modulations computed once per clip from the start
frame and broadcast over its T frames (K3's t = T); the JAX package repeats
the start frame T times, which gives the same values.  The train decode
renders frame by frame, each call advancing every spectral norm's u.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..flows import ParamTree
from ..flows.fc import build_supervised_transformer
from ..flows.loss import radial_sample
from ..nn.blocks import Conv, Conv2dBlock, NormConv2d, ResBlock, Spade, untyped
from ..nn.discriminators import Dense
from ..nn.encoders import ConvEncoder
from ..nn.motion import BasicBlock3d, Conv3d, _gn


class BaselineFCEncoder(nn.Module):
    """Image or poke -> vector latent (B, nf_max); ``variational`` adds the
    Dense mean and sigmoid log-std heads."""

    def __init__(self, nf_in: int, nf_max: int, spatial_size: int,
                 variational: bool = False):
        super().__init__()
        self.variational = variational
        self.ConvEncoder_0 = ConvEncoder(nf_in, nf_max, int(np.log2(spatial_size // 4)))
        self.NormConv2d_0 = NormConv2d(nf_max, nf_max, ks=4, st=1, padding=0)
        if variational:
            self.Dense_0 = Dense(nf_max, nf_max, bias=True)
            self.Dense_1 = Dense(nf_max, nf_max, bias=True)

    def forward(self, x, train: bool = False, noise: Optional[torch.Tensor] = None):
        """(z, mean, logstd): (vec, vec, None) when deterministic; z = mean
        without ``noise``, else mean + exp(logstd) * noise."""
        h = self.ConvEncoder_0(x, train)[0]
        vec = self.NormConv2d_0(h).reshape(x.shape[0], -1)
        if not self.variational:
            return vec, vec, None
        mu = self.Dense_0(vec)
        logstd = torch.sigmoid(self.Dense_1(vec))
        if noise is None:
            return mu, mu, logstd
        return mu + torch.exp(logstd) * noise, mu, logstd


class BaselineFCGenerator(nn.Module):
    """Vector -> image: a Dense to 4x4xdec_channels[0], an upsampling
    ResBlock to each further width (group norm without SPADE), SPADE after
    each with ``use_spade``, a 3x3 conv out (tanh at 3 channels)."""

    def __init__(self, z_dim: int, dec_channels: Sequence[int], out_channels: int = 3,
                 use_spade: bool = False, snorm: bool = True):
        super().__init__()
        self.use_spade, self.nf0 = use_spade, dec_channels[0]
        self.n_up = len(dec_channels) - 1
        self.Dense_0 = Dense(z_dim, 4 * 4 * self.nf0, bias=True)
        for i, (cin, nf) in enumerate(zip(dec_channels[:-1], dec_channels[1:])):
            self.add_module(f"ResBlock_{i}", ResBlock(
                cin, nf, norm="none" if use_spade else "group", upsampling=True,
                snorm=snorm))
            if use_spade:
                self.add_module(f"Spade_{i}", Spade(nf))
        self.Conv2dBlock_0 = Conv2dBlock(
            dec_channels[-1], out_channels, 3, 1, 1, norm="none",
            activation="tanh" if out_channels == 3 else "none")

    def spade_modulations(self, start_frame):
        """Per-level SPADE (gamma, beta) from the start frame alone."""
        return tuple(getattr(self, f"Spade_{i}").modulation(
            start_frame, 8 * 2 ** i, 8 * 2 ** i) for i in range(self.n_up))

    def forward(self, z, mods=None, train: bool = False):
        h = self.Dense_0(z).reshape(z.shape[0], 4, 4, self.nf0)
        for i in range(self.n_up):
            h = getattr(self, f"ResBlock_{i}")(h, train)
            if self.use_spade:
                h = getattr(self, f"Spade_{i}")(h, mods[i])
        return self.Conv2dBlock_0(h)


class FirstStageFCWrapper(nn.Module):
    """The FC AE of the FC image and poke encoders: ``encode`` gives (z,
    mean, logstd) with a vector latent, as ``FirstStageWrapper.encode``
    gives maps.  ``poke_and_image``: the encoder also takes the start frame
    (3 more input channels).  ``latent_shape``: one sample's latent."""

    min_spatial_size = 1  # a vector latent

    def __init__(self, spatial_size: int, nf_in: int, nf_max: int,
                 deterministic: bool = True, poke_and_image: bool = False):
        super().__init__()
        self.nf_max, self.deterministic = nf_max, deterministic
        self.poke_and_image = poke_and_image
        self.latent_shape = (nf_max,)
        self.encoder_net = BaselineFCEncoder(nf_in + (3 if poke_and_image else 0),
                                             nf_max, spatial_size,
                                             variational=not deterministic)
        n_up = int(np.log2(spatial_size // 4))
        chans = [nf_max] + [max(nf_max // 2 ** i, 32) for i in range(1, n_up + 1)]
        self.decoder_net = BaselineFCGenerator(nf_max, chans, out_channels=nf_in)

    def encode(self, x, train: bool = False, noise: Optional[torch.Tensor] = None):
        return self.encoder_net(x, train, noise)

    def decode(self, z, train: bool = False):
        return self.decoder_net(z, train=train)

    def forward(self, x, train: bool = False, noise: Optional[torch.Tensor] = None):
        return self.decode(self.encode(x, train, noise)[0], train)


class _VectorMotionEncoder(nn.Module):
    """3D-ResNet to a vector latent: the motion encoder's stem and stages
    (a fourth where 1/8 of the frame is above 4 px), the mean over the time
    left, then 4x4 valid conv heads for (mu, logvar)."""

    def __init__(self, channels: Sequence[int], z_dim: int, spatial_size: int,
                 layers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        ch = list(channels)
        self.Conv_0 = Conv3d(3, ch[0], (3, 7, 7), (2, 2, 2), (1, 3, 3))
        self.GroupNorm_0 = _gn(ch[0])
        stages = [(ch[1], layers[0], (2, 1, 1)), (ch[2], layers[1], (2, 2, 2)),
                  (ch[3], layers[2], (2, 2, 2))]
        if spatial_size // 2 ** 3 > 4:
            stages.append((ch[4] if len(ch) > 4 else ch[-1], layers[3], (2, 2, 2)))
        blocks, cin = [], ch[0]
        for planes, n, stride in stages:
            blocks += [BasicBlock3d(cin, planes, stride)]
            blocks += [BasicBlock3d(planes, planes) for _ in range(n - 1)]
            cin = planes
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"BasicBlock3d_{i}", blk)
        self.Conv_1 = Conv(cin, z_dim, 4)
        self.Conv_2 = Conv(cin, z_dim, 4)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """(z, mu, logvar), each (B, z_dim): z = mu + exp(logvar / 2) *
        noise, the noise given or drawn from ``generator``; z = mu with
        neither (the JAX encoder without a key)."""
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            h = getattr(self, f"BasicBlock3d_{i}")(h)
        h = h.mean(dim=1)
        mu = self.Conv_1(h).reshape(h.shape[0], -1)
        logvar = self.Conv_2(h).reshape(h.shape[0], -1)
        if generator is None and noise is None:
            return mu, mu, logvar
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                                dtype=mu.dtype)
        return mu + torch.exp(0.5 * logvar) * noise.to(mu.dtype), mu, logvar


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: r = s(ir(x) + hr(h)), z = s(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h; biases on ir,
    iz, in and hn only.  Built without ``dtype`` in the JAX package: its
    dense layers promote."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, untyped(Dense(cin, features, bias=True)))
        self.hr = untyped(Dense(features, features))
        self.hz = untyped(Dense(features, features))
        self.hn = untyped(Dense(features, features, bias=True))

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class FCBaselineModel(nn.Module):
    """The FC first stage, with ``FirstStageModel``'s interface
    (``forward``, ``encode``, ``decode``) so that ``FirstStageStep`` trains
    it.  ``deterministic`` only drops the KL term, as in the JAX package:
    the encoder samples whenever it is given noise or a generator.  Renders
    4 * 2^(len(dec_channels) - 1) px."""

    min_spatial_size = 1  # a vector latent

    def __init__(self, spatial_size: int, z_dim: int = 128,
                 enc_channels: Sequence[int] = (64, 128, 256, 256, 256),
                 dec_channels: Sequence[int] = (256, 256, 128, 64),
                 n_gru_layers: int = 2, use_spade: bool = True,
                 deterministic: bool = False, full_seq: bool = True):
        super().__init__()
        self.spatial_size, self.z_dim, self.full_seq = spatial_size, z_dim, full_seq
        self.deterministic, self.n_gru_layers = deterministic, n_gru_layers
        self.enc_motion = _VectorMotionEncoder(enc_channels, z_dim, spatial_size)
        for i in range(n_gru_layers):
            self.add_module(f"gru_{i}", GRUCell(z_dim, z_dim))
        self.gen = BaselineFCGenerator(z_dim, dec_channels, 3, use_spade)

    def encode(self, X, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """(z, mu, logvar) of the clip ``X`` (B, T+1, H, W, 3): all of it
        with ``full_seq``, else its T frames after the start frame."""
        return self.enc_motion(X if self.full_seq else X[:, 1:], generator, noise)

    def decode(self, motion, start_frame, length: int, train: bool = False):
        """The GRU rollout over ``length`` steps from ``motion`` (B, z), then
        the generator: (B, T, H, W, 3)."""
        hidden = [motion] * self.n_gru_layers
        hs = []
        for _ in range(length):
            inp = motion
            for i in range(self.n_gru_layers):
                hidden[i] = getattr(self, f"gru_{i}")(hidden[i], inp)
                inp = hidden[i]
            hs.append(hidden[-1])
        mods = self.gen.spade_modulations(start_frame) if self.gen.use_spade else None
        if train:
            return torch.stack([self.gen(h, mods, train=True) for h in hs], dim=1)
        frames = self.gen(torch.stack(hs, dim=1).flatten(0, 1), mods)  # b*T + t
        return frames.reshape(motion.shape[0], length, *frames.shape[1:])

    def forward(self, X, train: bool = False, noise: Optional[torch.Tensor] = None):
        motion, mu, logvar = self.encode(X, noise=noise)
        return self.decode(motion, X[:, 0], X.shape[1] - 1, train), mu, logvar


class SecondStageModelFC(nn.Module):
    """cINN over the FC first stage's vector latent, conditioned on
    h = [phi(x_0), phi(poke)] vectors; ``training.base_distribution:
    radial`` swaps the Gaussian base for the radial one."""

    def __init__(self, config, first_stage: FCBaselineModel,
                 conditioner: Optional[FirstStageFCWrapper],
                 poke_embedder: FirstStageFCWrapper, flow_params=None):
        super().__init__()
        self.config = config
        arch = config["architecture"]
        self.first_stage, self.conditioner = first_stage, conditioner
        self.poke_embedder = poke_embedder
        self.flow_in_channels = first_stage.z_dim
        self.min_spatial_size = 1
        h_channels = poke_embedder.nf_max + (conditioner.nf_max if conditioner else 0)
        self.flow = build_supervised_transformer(dict(
            arch, flow_in_channels=self.flow_in_channels, h_channels=h_channels,
            flow_mid_channels=int(arch.get("flow_mid_channels_factor", 8)
                                  * self.flow_in_channels)))
        self.radial = config.get("training", {}).get(
            "base_distribution", "gaussian") == "radial"
        self.flow_params = ParamTree(flow_params) if flow_params is not None else None

    def embed_conditioning(self, batch):
        poke, X = batch["poke"], batch["images"]
        if self.poke_embedder.poke_and_image:
            poke = torch.cat([poke, X[:, 0]], dim=-1)
        poke_emb = self.poke_embedder.encode(poke)[0]
        if self.conditioner is None:
            return poke_emb
        z, mean, _ = self.conditioner.encode(X[:, 0])
        return torch.cat([z if self.conditioner.deterministic else mean, poke_emb],
                         dim=-1)

    def _flow_input(self, batch, generator, noise):
        with torch.no_grad():
            cond = self.embed_conditioning(batch)
            motion = self.first_stage.encode(batch["images"], generator, noise)[0]
        return motion, cond

    def forward_density(self, batch, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None):
        """(z, logdet) of the batch's motion latent, a posterior sample drawn
        from ``generator`` (or from ``noise``; mu with neither)."""
        motion, cond = self._flow_input(batch, generator, noise)
        return self.flow.forward(self.flow_params.tree(), motion, cond)

    @torch.no_grad()
    def ddi(self, batch, generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
        motion, cond = self._flow_input(batch, generator, noise)
        return self.flow.ddi(self.flow_params.tree(), motion, cond)[2]

    def sample_base(self, batch_size: int, generator=None, device=None, dtype=None):
        shape = (batch_size, self.flow_in_channels)
        if self.radial:
            return radial_sample(shape, generator, device, dtype)
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    @torch.no_grad()
    def forward_sample(self, batch, length: int,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None):
        """Videos (B, T, H, W, 3) from z of the base (or the given ``z``)
        through the cINN inverse and the FC first stage's batched decode."""
        x = batch["images"]
        cond = self.embed_conditioning(batch)
        if z is None:
            z = self.sample_base(x.shape[0], generator, x.device, x.dtype)
        motion = self.flow.inverse(self.flow_params.tree(), z, cond)
        return self.first_stage.decode(motion, x[:, 0], length)
