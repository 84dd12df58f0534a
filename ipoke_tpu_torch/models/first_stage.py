"""First-stage video autoencoder, frozen (counterpart of
``ipoke_tpu/models/first_stage.py``): the motion encoder (``encode``, used by
second-stage training) and the decode of sampling.  The GRU's input is the
learned motion bias, as at the shipped config (``motion_bias: True``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.encoders import SpadeCondConvDecoder
from ..nn.gru import ConvGRU
from ..nn.motion import ResNetMotionEncoder


class FirstStageModel(nn.Module):
    def __init__(self, spatial_size: int, z_dim: int = 32,
                 dec_channels: Sequence[int] = (256, 256, 256, 128, 64),
                 n_gru_layers: int = 4, min_spatial_size: int = 8,
                 norm: str = "group",
                 enc_channels: Optional[Sequence[int]] = None,
                 max_frames: int = 10, deterministic: bool = False):
        """``enc_channels`` None leaves the motion encoder out (sampling
        does not run it)."""
        super().__init__()
        self.spatial_size, self.z_dim = spatial_size, z_dim
        if enc_channels is not None:
            self.enc_motion = ResNetMotionEncoder(
                enc_channels, z_dim, spatial_size, max_frames,
                min_spatial_size, deterministic)
        self.n_gru_layers, self.min_spatial_size = n_gru_layers, min_spatial_size
        self.rnn = ConvGRU(z_dim, z_dim, n_gru_layers)
        self.motion_bias = nn.Parameter(
            torch.empty(1, min_spatial_size, min_spatial_size, z_dim))
        self.gen = SpadeCondConvDecoder(z_dim, dec_channels, 3, norm)

    def encode(self, X, generator: Optional[torch.Generator] = None):
        """(z, mu, logvar) of the whole clip ``X`` (B, T+1, H, W, 3), as
        with the JAX package's ``full_seq``; z = mu without a generator or
        when deterministic."""
        return self.enc_motion(X, generator)

    def decode(self, motion, start_frame, length: int):
        """ConvGRU rollout over ``length`` frames from ``motion`` (B, s, s, z),
        then one batched SPADE decode of all B*T frames (B-major), with the
        per-clip SPADE modulations computed once from the start frame.
        Returns (B, T, H, W, 3)."""
        hidden = tuple(motion for _ in range(self.n_gru_layers))
        in_rnn = self.motion_bias.expand(motion.shape[0], -1, -1, -1)
        mods = self.gen.spade_modulations(start_frame, motion.shape[1])
        hs = []
        for _ in range(length):
            hidden = self.rnn(in_rnn, hidden)
            hs.append(hidden[-1])
        flat = torch.stack(hs, dim=1).flatten(0, 1)  # frame index b*T + t
        frames = self.gen(flat, mods)
        return frames.reshape(motion.shape[0], length, *frames.shape[1:])
