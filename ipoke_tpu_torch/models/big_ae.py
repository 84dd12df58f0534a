"""BigGAN-style autoencoder (counterpart of ``ipoke_tpu/models/big_ae.py``),
NHWC: a ResNet encoder to a diagonal-Gaussian posterior over ``z_dim`` and
a BigGAN generator (z split into per-block chunks, class-conditional batch
norm driven by an embedding of z, SAGAN self-attention at 32 px, residual
up-blocks).  The flow encoder of ``flow_encoder_fc`` (2-channel flow maps)
and its image variant (3 channels).

Module names repeat flax's so that ``convert.load_flax`` maps a flax tree
onto them.  The conditional batch norms always normalise by the batch's
statistics (eps 1e-4, no running statistics, in eval too); the GroupNorms
keep flax's eps 1e-6; the nearest 2x upsampling is a repeat.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import Conv, GroupNorm
from ..nn.discriminators import Dense

_GN_EPS = 1e-6  # flax nn.GroupNorm's default


class ConditionalBatchNorm(nn.Module):
    """BN without learned affine; gamma and beta from the conditioning
    vector."""

    def __init__(self, features: int, cond_dim: int):
        super().__init__()
        self.Dense_0 = Dense(cond_dim, features)
        self.Dense_1 = Dense(cond_dim, features)

    def forward(self, x, cond):
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
        xn = (x - mean) * torch.rsqrt(var + 1e-4)
        gamma, beta = self.Dense_0(cond), self.Dense_1(cond)
        return xn * (1.0 + gamma[:, None, None, :]) + beta[:, None, None, :]


class SelfAttention(nn.Module):
    """SAGAN attention: theta against the 2x2 max-pooled phi, softmax over
    the pooled pixels, the pooled g read through it, a 1x1 conv out, scaled
    by a learned ``gamma`` (0 at init)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.Conv_0 = Conv(c, c // 8, 1, bias=False)
        self.Conv_1 = Conv(c, c // 8, 1, bias=False)
        self.Conv_2 = Conv(c, c // 2, 1, bias=False)
        self.Conv_3 = Conv(c // 2, c, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def init_random(self, generator) -> None:
        self.gamma.zero_()

    def forward(self, x):
        b, h, w, c = x.shape
        pool = lambda t: F.max_pool2d(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        theta = self.Conv_0(x).reshape(b, h * w, -1)
        phi = pool(self.Conv_1(x)).reshape(b, -1, c // 8)
        g = pool(self.Conv_2(x)).reshape(b, -1, c // 2)
        attn = torch.softmax(theta @ phi.transpose(1, 2), dim=-1)
        o = self.Conv_3((attn @ g).reshape(b, h, w, c // 2))
        return x + self.gamma * o


def _up(x):
    """``jax.image.resize(..., "nearest")`` to twice the size."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class GBlock(nn.Module):
    """CBN-relu-up-conv twice, residual (1x1 conv where the width changes)."""

    def __init__(self, cin: int, out_channels: int, cond_dim: int,
                 upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        self.ConditionalBatchNorm_0 = ConditionalBatchNorm(cin, cond_dim)
        self.Conv_0 = Conv(cin, out_channels, 3, 1, 1)
        self.ConditionalBatchNorm_1 = ConditionalBatchNorm(out_channels, cond_dim)
        self.Conv_1 = Conv(out_channels, out_channels, 3, 1, 1)
        if cin != out_channels:
            self.Conv_2 = Conv(cin, out_channels, 1)

    def forward(self, x, cond):
        h = F.relu(self.ConditionalBatchNorm_0(x, cond))
        if self.upsample:
            h, x = _up(h), _up(x)
        h = self.Conv_0(h)
        h = self.Conv_1(F.relu(self.ConditionalBatchNorm_1(h, cond)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class BigGANGenerator(nn.Module):
    """z (B, z_dim) split into n_blocks + 1 chunks: the first through a
    Dense to 4x4, each other (with the class embedding) conditions one
    up-block's CBNs; self-attention after the block that reaches
    ``attention_at``; GroupNorm, relu, a 3x3 conv and tanh."""

    def __init__(self, spatial_size: int = 64, ch: int = 48, z_dim: int = 128,
                 embed_dim: int = 128, out_channels: int = 3,
                 attention_at: int = 32):
        super().__init__()
        n_blocks = int(np.log2(spatial_size)) - 2  # 4x4 start
        mults_out = [16, 8, 4, 2, 1][:n_blocks]
        mults_in = [16] + mults_out[:-1]
        self.n_blocks, self.chunk = n_blocks, z_dim // (n_blocks + 1)
        self.Dense_0 = Dense(self.chunk, 4 * 4 * mults_in[0] * ch, bias=True)
        self.c0, res, self.attn_after = mults_in[0] * ch, 4, None
        for i, (m_in, m_out) in enumerate(zip(mults_in, mults_out)):
            self.add_module(f"GBlock_{i}", GBlock(m_in * ch, m_out * ch,
                                                  self.chunk + embed_dim))
            res *= 2
            if res == attention_at:
                self.attn_after = i
                self.SelfAttention_0 = SelfAttention(m_out * ch)
        c_last = mults_out[-1] * ch
        self.GroupNorm_0 = GroupNorm(min(16, c_last), c_last, eps=_GN_EPS)
        self.Conv_0 = Conv(c_last, out_channels, 3, 1, 1)

    def forward(self, z, embed):
        chunks = torch.split(z, self.chunk, dim=-1)
        h = self.Dense_0(chunks[0]).reshape(z.shape[0], 4, 4, self.c0)
        for i in range(self.n_blocks):
            h = getattr(self, f"GBlock_{i}")(h, torch.cat([chunks[i + 1], embed], dim=-1))
            if i == self.attn_after:
                h = self.SelfAttention_0(h)
        return torch.tanh(self.Conv_0(F.relu(self.GroupNorm_0(h))))


class ClassUp(nn.Module):
    """z -> a unit-norm class embedding (Dense, leaky relu 0.2, Dense)."""

    def __init__(self, z_dim: int, out_dim: int = 128, hidden: int = 256):
        super().__init__()
        self.Dense_0 = Dense(z_dim, hidden, bias=True)
        self.Dense_1 = Dense(hidden, out_dim, bias=True)

    def forward(self, z):
        h = self.Dense_1(F.leaky_relu(self.Dense_0(z), 0.2))
        return h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-8)


class _EncBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        g = min(16, planes)
        self.Conv_0 = Conv(cin, planes, 3, stride, 1, bias=False)
        self.GroupNorm_0 = GroupNorm(g, planes, eps=_GN_EPS)
        self.Conv_1 = Conv(planes, planes, 3, 1, 1, bias=False)
        self.GroupNorm_1 = GroupNorm(g, planes, eps=_GN_EPS)
        if stride != 1 or cin != planes:
            self.Conv_2 = Conv(cin, planes, 1, stride, bias=False)

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return F.relu(h + x)


class ResnetEncoder(nn.Module):
    """ResNet to (mu, logvar) over ``z_dim``, logvar clipped to [-30, 20]."""

    def __init__(self, z_dim: int, in_channels: int,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 blocks_per_stage: int = 2):
        super().__init__()
        self.Conv_0 = Conv(in_channels, channels[0], 7, 2, 3, bias=False)
        self.GroupNorm_0 = GroupNorm(16, channels[0], eps=_GN_EPS)
        blocks, cin = [], channels[0]
        for i, c in enumerate(channels):
            blocks.append(_EncBlock(cin, c, 1 if i == 0 else 2))
            blocks += [_EncBlock(c, c) for _ in range(blocks_per_stage - 1)]
            cin = c
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"_EncBlock_{i}", blk)
        self.Dense_0 = Dense(cin, 2 * z_dim, bias=True)

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        # flax nn.max_pool pads with -inf, as max_pool2d does
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for i in range(self.n_blocks):
            h = getattr(self, f"_EncBlock_{i}")(h)
        mu, logvar = torch.chunk(self.Dense_0(h.mean(dim=(1, 2))), 2, dim=-1)
        return mu, torch.clamp(logvar, -30.0, 20.0)


class BigAE(nn.Module):
    """encoder -> diagonal Gaussian z -> BigGAN decoder.  z is zero-padded
    to ``gen_z_dim``, the next multiple of the generator's chunks."""

    def __init__(self, z_dim: int, spatial_size: int = 64, in_channels: int = 2,
                 gen_ch: int = 48):
        super().__init__()
        self.z_dim, self.in_channels = z_dim, in_channels
        n = int(np.log2(spatial_size)) - 2 + 1  # + the input chunk
        self.gen_z_dim = -(-z_dim // n) * n
        self.encoder = ResnetEncoder(z_dim, in_channels)
        self.class_up = ClassUp(self.gen_z_dim)
        self.decoder = BigGANGenerator(spatial_size, gen_ch, self.gen_z_dim,
                                       out_channels=in_channels)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        pad = self.gen_z_dim - self.z_dim
        if pad:
            z = torch.cat([z, z.new_zeros((z.shape[0], pad))], dim=-1)
        return self.decoder(z, self.class_up(z))

    def forward(self, x, noise: Optional[torch.Tensor] = None):
        """(rec, mu, logvar): z = mu + exp(logvar / 2) * noise (mu without
        ``noise``)."""
        mu, logvar = self.encoder(x)
        z = mu if noise is None else mu + torch.exp(0.5 * logvar) * noise
        return self.decode(z), mu, logvar


def gaussian_kl(mu, logvar):
    """KL(q || N(0, I)), summed over z, mean over the batch."""
    return torch.mean(0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - 1.0 - logvar,
                                      dim=-1))
