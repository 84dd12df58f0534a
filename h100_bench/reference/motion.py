"""Plain PyTorch 3D convs of the first stage, (B, T, H, W, C): the motion
encoder (``ipoke_tpu_torch/nn/motion.py``) and the temporal discriminator's
blocks, written out again in fp32 with the port's names."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nets import Conv, GroupNorm, SpectralNormed, num_groups

GN_EPS = 1e-6  # flax nn.GroupNorm's default, kept by these nets


def gn(c, groups=None):
    return GroupNorm(groups or num_groups(c), c, eps=GN_EPS)


class Conv3d(SpectralNormed):
    """3D conv without bias, OIDHW weight, symmetric padding per axis."""

    def __init__(self, cin, cout, ks, stride=(1, 1, 1), padding=(0, 0, 0), snorm=False):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *ks))
        self.bias = None
        self._init_snorm(snorm, cout)

    def fan_in(self):
        return int(np.prod(self.weight.shape[1:]))

    def forward(self, x, train=False):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.normed_weight(train), None,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class BasicBlock3d(nn.Module):
    def __init__(self, inplanes, planes, stride=(1, 1, 1)):
        super().__init__()
        self.Conv_0 = Conv3d(inplanes, planes, (3, 3, 3), stride, (1, 1, 1))
        self.GroupNorm_0 = gn(planes)
        self.Conv_1 = Conv3d(planes, planes, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        self.GroupNorm_1 = gn(planes)
        self.has_res = tuple(stride) != (1, 1, 1) or inplanes != planes
        if self.has_res:
            self.Conv_2 = Conv3d(inplanes, planes, (1, 1, 1), stride)
            self.GroupNorm_2 = gn(planes)

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        return F.relu(h + (self.GroupNorm_2(self.Conv_2(x)) if self.has_res else x))


class ResNetMotionEncoder(nn.Module):
    """Conv3d stem, ResNet-18 stages with the port's strides, a mean over
    the time left, 3x3 heads for (mu, logvar); z = noise * exp(logvar / 2)
    + mu."""

    def __init__(self, channels, z_dim, spatial, max_frames, min_spatial=8, full_seq=True):
        super().__init__()
        ch = list(channels)
        self.Conv_0 = Conv3d(3, ch[0], (3, 7, 7), (2, 2, 2), (1, 3, 3))
        self.GroupNorm_0 = gn(ch[0])
        down = full_seq or len(ch) - 1 < int(np.ceil(np.log2(max_frames)))
        stages = [(ch[1], (2, 1, 1) if down else (1, 1, 1)), (ch[2], (2, 2, 2)),
                  (ch[3], (2, 2, 2))]
        stride4 = (2, 1, 1) if full_seq and max_frames >= 16 else None
        if spatial // 2 ** 3 > min_spatial:
            stride4 = (2, 2, 2)
        if stride4 is not None:
            stages.append((ch[4] if len(ch) > 4 else ch[-1], stride4))
        if spatial // 2 ** 4 > min_spatial:
            stages.append((ch[5] if len(ch) > 5 else ch[-1], (2, 2, 2)))
        blocks, cin = [], ch[0]
        for planes, stride in stages:
            blocks += [BasicBlock3d(cin, planes, stride), BasicBlock3d(planes, planes)]
            cin = planes
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"BasicBlock3d_{i}", blk)
        self.Conv_1 = Conv(cin, z_dim, 3, 1, 1)
        self.Conv_2 = Conv(cin, z_dim, 3, 1, 1)

    def forward(self, x, noise):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            h = getattr(self, f"BasicBlock3d_{i}")(h)
        h = h.mean(dim=1)
        mu, logvar = self.Conv_1(h), self.Conv_2(h)
        return noise * torch.exp(0.5 * logvar) + mu, mu, logvar
