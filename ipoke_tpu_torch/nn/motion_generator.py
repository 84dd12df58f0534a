"""The alternative 3D-conv video generator (counterpart of
``ipoke_tpu/nn/motion_generator.py``, the reference's
``motion_models/motion_generator.py``; no config builds it): z -> Dense ->
a (1, 4, 4, 16 nf) seed, then up-blocks of [SPADE(start frame) +
AdaIN(z)]-modulated Conv3d pairs with trilinear upsampling over (T, H, W).

Module names repeat flax's, so ``convert.load_flax`` maps a flax tree onto
it.  ``jax.image.resize``'s trilinear doubling is torch's trilinear
interpolation with half-pixel centres (upsampling needs no antialiasing);
the start frame's bilinear resize to a smaller block antialiases, as in
the SPADE decoder (``blocks.resize_bilinear``).  The SPADE GroupNorm is
flax's default ``nn.GroupNorm``: eps 1e-6, no scale or bias."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import AdaIN, Conv, _num_groups, group_norm, resize_bilinear
from .discriminators import Dense
from .motion import Conv3d


class _Conv3d(Conv3d):
    """flax ``nn.Conv`` (3, 3, 3) with padding 1 and a bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (3, 3, 3), padding=(1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, train: bool = False):
        return super().forward(x, train) + self.bias.to(x.dtype)


class _Spade3D(nn.Module):
    """SPADE over (B, T, H, W, C) conditioned on the start frame."""

    def __init__(self, num_features: int, cond_channels: int = 3, hidden: int = 128):
        super().__init__()
        self.num_features = num_features
        self.Conv_0 = Conv(cond_channels, hidden, 3, 1, 1)
        self.Conv_1 = Conv(hidden, num_features, 3, 1, 1)
        self.Conv_2 = Conv(hidden, num_features, 3, 1, 1)

    def forward(self, x, y):
        normalized = group_norm(x, _num_groups(self.num_features), eps=1e-6)
        y = resize_bilinear(y, x.shape[2], x.shape[3])
        y = F.leaky_relu(self.Conv_0(y), 0.2)
        return normalized * (1.0 + self.Conv_1(y)[:, None]) + self.Conv_2(y)[:, None]


class GeneratorBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, t_up: bool, z_dim: int):
        super().__init__()
        self.t_up = t_up
        self._Spade3D_0 = _Spade3D(in_channels)
        self.Conv_0 = _Conv3d(in_channels, out_channels)
        self.AdaIN_0 = AdaIN(out_channels, z_dim)
        self.Conv_1 = _Conv3d(out_channels, out_channels)

    def forward(self, x, start_frame, z):
        _, t, h, w, _ = x.shape
        size = (2 * t if self.t_up else t, 2 * h, 2 * w)
        x = F.interpolate(x.permute(0, 4, 1, 2, 3), size=size, mode="trilinear",
                          align_corners=False).permute(0, 2, 3, 4, 1)
        x = F.leaky_relu(self._Spade3D_0(x, start_frame), 0.2)
        x = F.leaky_relu(self.AdaIN_0(self.Conv_0(x), z), 0.2)
        return self.Conv_1(x)


class Generator3D(nn.Module):
    """(B, z_dim) and the start frame (B, S, S, 3) -> (B, T, S, S, 3) video
    (the reference's ``Generator``)."""

    def __init__(self, nf: int = 16, z_dim: int = 128, spatial_size: int = 64,
                 max_frames: int = 10):
        super().__init__()
        self.nf, self.max_frames = nf, max_frames
        n_up = int(math.log2(spatial_size // 4))
        t_ups = math.ceil(math.log2(max_frames))
        chans = [max(16 * nf // (2 ** (i + 1)), nf) for i in range(n_up)]
        self.Dense_0 = Dense(z_dim, 4 * 4 * 16 * nf, bias=True)
        cin = 16 * nf
        for i, c in enumerate(chans):
            setattr(self, f"GeneratorBlock3D_{i}", GeneratorBlock3D(cin, c, i < t_ups, z_dim))
            cin = c
        self.n_blocks = n_up
        self.Conv_0 = _Conv3d(cin, 3)

    def forward(self, z, start_frame):
        h = self.Dense_0(z).reshape(z.shape[0], 1, 4, 4, 16 * self.nf)
        for i in range(self.n_blocks):
            h = getattr(self, f"GeneratorBlock3D_{i}")(h, start_frame, z)
        return torch.tanh(self.Conv_0(h))[:, :self.max_frames]
