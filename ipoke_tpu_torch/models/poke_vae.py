"""The poke-conditioned cVAE baseline (counterpart of
``ipoke_tpu/models/poke_vae.py``).

``PokeVAEModel``: the first stage's 3D motion encoder, ConvGRU and SPADE
decoder, with the GRU driven by a poke representation, a ``ConvEncoder``
over [start frame, poke] down to the motion latent's map: as the GRU's
input (default) or stacked with the motion latent as its initial state
(``stack_motion_and_poke``, a GRU of 2 z_dim channels on zero inputs).
Sampling draws motion ~ N(0, I) (``sample_prior``) while the poke still
steers the rollout.  It trains under the first stage's VAE-GAN step
(``models.first_stage.FirstStageStep`` passes the batch's poke to a model
that ``needs_poke``) with the KL ramp of ``training.kl_annealing``.

``RNNMotionModel``: a scene encoder on the start frame feeds the ConvGRU's
input, and a plain ``ConvDecoder`` renders each hidden state through a 3x3
conv.  Nothing builds it in either package; it is here with its file.

Module names repeat flax's, so ``convert.load_flax`` carries a JAX run's
weights over."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.blocks import Conv
from ..nn.encoders import ConvDecoder, ConvEncoder, SpadeCondConvDecoder
from ..nn.gru import ConvGRU
from ..nn.motion import ResNetMotionEncoder


def _n_stages(spatial_size: int, min_spatial_size: int) -> int:
    return int(np.log2(spatial_size // min_spatial_size))


class _Rollout(nn.Module):
    """The motion encoder both models share."""

    def _encoded(self, X):
        return X if self.full_seq else X[:, 1:]

    def encode(self, X, generator: Optional[torch.Generator] = None):
        """(z, mu, logvar) of the clip ``X`` (B, T+1, H, W, 3), as
        ``FirstStageModel.encode``."""
        return self.enc_motion(self._encoded(X), generator)


class PokeVAEModel(_Rollout):
    """Interface of ``FirstStageModel`` plus the poke: ``forward(X, train,
    noise, poke, sample_prior)``, ``encode``, ``decode(..., poke)``."""

    needs_poke = True

    def __init__(self, spatial_size: int, z_dim: int = 32,
                 enc_channels: Sequence[int] = (64, 128, 256, 256, 256),
                 dec_channels: Sequence[int] = (256, 256, 256, 128, 64),
                 n_gru_layers: int = 4, min_spatial_size: int = 8,
                 max_frames: int = 10, full_seq: bool = True,
                 stack_motion_and_poke: bool = False, norm: str = "group",
                 spectral_norm: bool = True, deterministic: bool = False):
        super().__init__()
        self.spatial_size, self.z_dim = spatial_size, z_dim
        self.min_spatial_size, self.n_gru_layers = min_spatial_size, n_gru_layers
        self.full_seq, self.deterministic = full_seq, deterministic
        self.stack_motion_and_poke = stack_motion_and_poke
        self.enc_motion = ResNetMotionEncoder(
            enc_channels, z_dim, spatial_size, max_frames, min_spatial_size,
            deterministic, full_seq)
        hidden = 2 * z_dim if stack_motion_and_poke else z_dim
        self.rnn = ConvGRU(hidden, hidden, n_gru_layers)
        self.poke_enc = ConvEncoder(5, z_dim, _n_stages(spatial_size, min_spatial_size))
        self.gen = SpadeCondConvDecoder(hidden, dec_channels, 3, norm, snorm=spectral_norm)

    def decode(self, motion, start_frame, length: int, train: bool = False,
               poke=None):
        """The rollout over ``length`` frames from ``motion`` (B, s, s, z)
        steered by ``poke`` (B, H, W, 2); frames as ``FirstStageModel.decode``
        renders them (one batched decode in eval, frame by frame in
        train)."""
        if poke is None:
            raise ValueError("PokeVAE decoding requires a poke map")
        poke_repr = self.poke_enc(torch.cat([start_frame, poke.to(start_frame.dtype)],
                                            dim=-1), train)[0]
        if self.stack_motion_and_poke:
            state0 = torch.cat([motion, poke_repr], dim=-1)
            in_rnn = torch.zeros_like(state0)
        else:
            state0, in_rnn = motion, poke_repr
        hidden = tuple(state0 for _ in range(self.n_gru_layers))
        mods = self.gen.spade_modulations(start_frame, motion.shape[1])
        hs, frames = [], []
        for _ in range(length):
            hidden = self.rnn(in_rnn, hidden)
            if train:
                frames.append(self.gen(hidden[-1], mods, train=True))
            else:
                hs.append(hidden[-1])
        if train:
            return torch.stack(frames, dim=1)
        flat = torch.stack(hs, dim=1).flatten(0, 1)  # frame index b*T + t
        frames = self.gen(flat, mods)
        return frames.reshape(motion.shape[0], length, *frames.shape[1:])

    def forward(self, X, train: bool = False, noise=None, poke=None,
                sample_prior: bool = False):
        """(X_hat (B, T, H, W, 3), mu, logvar): the posterior's motion (z =
        noise * exp(logvar / 2) + mu, mu without ``noise``) or, with
        ``sample_prior``, ``noise`` itself as the N(0, I) motion (mu and
        logvar zero), decoded under ``poke``."""
        if sample_prior:
            if noise is None:
                raise ValueError("sample_prior needs the prior draw as noise")
            motion = noise.to(X.dtype)
            mu = logvar = torch.zeros_like(motion)
        else:
            motion, mu, logvar = self.enc_motion(self._encoded(X), noise=noise)
        return self.decode(motion, X[:, 0], X.shape[1] - 1, train, poke), mu, logvar


class RNNMotionModel(_Rollout):
    """``forward(X, train, noise)``: the clip's motion latent as every GRU
    layer's initial state, the scene encoding of the start frame as the
    first input, then each step's 3x3 ``post_hidden`` of the last hidden
    state as the next input and the frame rendered from it."""

    def __init__(self, spatial_size: int, z_dim: int = 32,
                 enc_channels: Sequence[int] = (64, 128, 256, 256, 256),
                 dec_channels: Sequence[int] = (256, 256, 256, 128, 64),
                 n_gru_layers: int = 4, min_spatial_size: int = 8,
                 max_frames: int = 10, full_seq: bool = True,
                 deterministic: bool = False):
        super().__init__()
        self.z_dim, self.n_gru_layers = z_dim, n_gru_layers
        self.full_seq, self.deterministic = full_seq, deterministic
        # the JAX model builds its encoder without ``deterministic``
        self.enc_motion = ResNetMotionEncoder(
            enc_channels, z_dim, spatial_size, max_frames, min_spatial_size,
            False, full_seq)
        self.enc_static = ConvEncoder(3, z_dim, _n_stages(spatial_size, min_spatial_size))
        self.rnn = ConvGRU(z_dim, z_dim, n_gru_layers)
        self.post_hidden = Conv(z_dim, z_dim, 3, 1, 1)
        self.gen = ConvDecoder(z_dim, tuple(dec_channels), 3)

    def decode(self, motion, start_frame, length: int, train: bool = False):
        x = self.enc_static(start_frame, train)[0]
        hidden = tuple(motion for _ in range(self.n_gru_layers))
        xs = []
        for _ in range(length):
            hidden = self.rnn(x, hidden)
            x = self.post_hidden(hidden[-1])
            xs.append(x)
        if train:
            return torch.stack([self.gen(x, train=True) for x in xs], dim=1)
        flat = torch.stack(xs, dim=1).flatten(0, 1)
        frames = self.gen(flat)
        return frames.reshape(motion.shape[0], length, *frames.shape[1:])

    def forward(self, X, train: bool = False, noise=None, poke=None):
        del poke
        motion, mu, logvar = self.enc_motion(self._encoded(X), noise=noise)
        return self.decode(motion, X[:, 0], X.shape[1] - 1, train), mu, logvar
