"""3D-ResNet motion encoder (counterpart of ``ipoke_tpu/nn/motion.py``).

Video layout (B, T, H, W, C) as in the JAX package; each conv runs as
``F.conv3d`` (cuDNN on the card) on an NCDHW view.  A Conv3d stem (3,7,7)
with stride (2,2,2) and GroupNorm(16), ResNet-18-style stages whose temporal
and spatial strides follow ``max_frames``, ``full_seq`` and
``min_spatial_size`` as in the JAX package, a mean over the time left, 3x3 conv heads for (mu, logvar), and a reparameterised sample
whose noise comes from a ``torch.Generator``.  Names repeat flax's so that ``convert.load_flax``
maps a flax tree onto the module.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv, GroupNorm, SpectralNormed, Typed, _num_groups, promote, untyped

# flax ``nn.GroupNorm``'s default epsilon (the motion encoder keeps it)
_GN_EPS = 1e-6


def _gn(c: int) -> GroupNorm:
    """The motion encoder's GroupNorm: flax's, built without ``dtype``."""
    return untyped(GroupNorm(_num_groups(c), c, eps=_GN_EPS))


class Conv3d(Typed, SpectralNormed):
    """flax ``nn.Conv`` on (B, T, H, W, C) tensors without bias.  ``weight``
    is OIDHW (converted from flax's DHWIO kernel); ``padding`` symmetric per
    axis (a 1x1x1 kernel under flax's SAME pads nothing); ``snorm`` as in
    ``blocks.SpectralNormed``."""

    def __init__(self, cin: int, cout: int, ks: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1),
                 padding: Tuple[int, int, int] = (0, 0, 0), snorm: bool = False):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *ks))
        self._init_snorm(snorm, cout)

    def forward(self, x, train: bool = False):
        x, w = promote(self.compute_dtype, x, self.normed_weight(train))
        xc = x.permute(0, 4, 1, 2, 3)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            # the fp32 product rounded once, as XLA's CPU conv computes a
            # bf16 conv: torch's CPU bf16 conv3d read uninitialised memory
            # on an AVX512 host (torch 2.11: outputs that differ from run
            # to run on equal inputs, and NaN)
            y = F.conv3d(xc.float(), w.float(), None, stride=self.stride,
                         padding=self.padding).to(x.dtype)
        else:
            y = F.conv3d(xc, w, None, stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class BasicBlock3d(nn.Module):
    def __init__(self, inplanes: int, planes: int,
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        self.Conv_0 = Conv3d(inplanes, planes, (3, 3, 3), stride, (1, 1, 1))
        self.GroupNorm_0 = _gn(planes)
        self.Conv_1 = Conv3d(planes, planes, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        self.GroupNorm_1 = _gn(planes)
        self.has_res = tuple(stride) != (1, 1, 1) or inplanes != planes
        if self.has_res:
            self.Conv_2 = Conv3d(inplanes, planes, (1, 1, 1), stride)
            self.GroupNorm_2 = _gn(planes)

    def forward(self, x):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        res = self.GroupNorm_2(self.Conv_2(x)) if self.has_res else x
        return F.relu(h + res)


class ResNetMotionEncoder(nn.Module):
    """Returns (z, mu, logvar); mu/logvar are (B, s, s, z_dim) maps."""

    def __init__(self, channels: Sequence[int], z_dim: int, spatial_size: int,
                 max_frames: int, min_spatial_size: int = 8,
                 deterministic: bool = False, full_seq: bool = True):
        super().__init__()
        ch = list(channels)
        self.deterministic = deterministic
        self.Conv_0 = Conv3d(3, ch[0], (3, 7, 7), (2, 2, 2), (1, 3, 3))
        self.GroupNorm_0 = _gn(ch[0])
        # the JAX package's strides: stage 1 halves time with full_seq (the
        # whole clip) or when the channels are few for log2(max_frames);
        # stage 4 runs if time (full_seq, 16+ frames) or space is left to
        # cut, stage 5 if space is
        down = full_seq or len(ch) - 1 < int(np.ceil(np.log2(max_frames)))
        stages = [(ch[1], (2, 1, 1) if down else (1, 1, 1)), (ch[2], (2, 2, 2)),
                  (ch[3], (2, 2, 2))]
        stride4 = (2, 1, 1) if full_seq and max_frames >= 16 else None
        if spatial_size // 2 ** 3 > min_spatial_size:
            stride4 = (2, 2, 2)
        if stride4 is not None:
            stages.append((ch[4] if len(ch) > 4 else ch[-1], stride4))
        if spatial_size // 2 ** 4 > min_spatial_size:
            stages.append((ch[5] if len(ch) > 5 else ch[-1], (2, 2, 2)))
        blocks, cin = [], ch[0]
        for planes, stride in stages:  # two BasicBlocks a stage (ResNet-18)
            blocks += [BasicBlock3d(cin, planes, stride),
                       BasicBlock3d(planes, planes)]
            cin = planes
        self.n_blocks = len(blocks)
        for i, blk in enumerate(blocks):
            self.add_module(f"BasicBlock3d_{i}", blk)
        self.Conv_1 = Conv(cin, z_dim, 3, 1, 1)
        self.Conv_2 = Conv(cin, z_dim, 3, 1, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """z = noise * exp(logvar / 2) + mu, with ``noise`` given or drawn
        from ``generator``; z = mu when deterministic or given neither."""
        h = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            h = getattr(self, f"BasicBlock3d_{i}")(h)
        h = h.mean(dim=1)  # the time left after the strides
        mu, logvar = self.Conv_1(h), self.Conv_2(h)
        if self.deterministic or (generator is None and noise is None):
            return mu, mu, logvar
        if noise is None:
            noise = torch.randn(logvar.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        return noise.to(mu.dtype) * torch.exp(0.5 * logvar) + mu, mu, logvar
