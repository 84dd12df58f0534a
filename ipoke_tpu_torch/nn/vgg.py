"""VGG19 feature taps and the perceptual loss (counterpart of
``ipoke_tpu/nn/vgg.py``), NHWC.

The net stops at conv5_1, the last of the five relu*_1 taps; the [-1, 1]
input goes in without ImageNet normalisation, as in the JAX package.  Its
weights are carried from the JAX tree (``convert.load_flax``), read from a
converted torchvision npz (``load_torch_vgg19_npz``; ``entry.build_vgg``
does so when ``IPOKE_VGG_WEIGHTS`` names one) or drawn from a generator
(``entry``): nothing is downloaded.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv

# (out_channels, n_convs) per VGG19 block, truncated at conv5_1
_CFG = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 1))


class VGG19Features(nn.Module):
    """The 5 tap activations (relu1_1 .. relu5_1) of an NHWC image batch."""

    def __init__(self, cin: int = 3):
        super().__init__()
        for b, (ch, n_convs) in enumerate(_CFG):
            for c in range(n_convs):
                self.add_module(f"conv{b + 1}_{c + 1}", Conv(cin, ch, 3, 1, 1))
                cin = ch

    def forward(self, x):
        taps = []
        for b, (_, n_convs) in enumerate(_CFG):
            for c in range(n_convs):
                x = F.relu(getattr(self, f"conv{b + 1}_{c + 1}")(x))
                if c == 0:
                    taps.append(x)
            if b < len(_CFG) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return taps


def load_torch_vgg19_npz(vgg: VGG19Features, path: str) -> VGG19Features:
    """Torchvision VGG19 weights from an npz with keys ``features.{i}.weight``
    (OIHW) and ``features.{i}.bias`` (the JAX package's
    ``load_torch_vgg19_npz`` layout) into ``vgg``, in place."""
    raw = np.load(path)
    idx = 0
    with torch.no_grad():
        for b, (_, n_convs) in enumerate(_CFG):
            for c in range(n_convs):
                conv = getattr(vgg, f"conv{b + 1}_{c + 1}")
                conv.weight.copy_(torch.as_tensor(raw[f"features.{idx}.weight"]))
                conv.bias.copy_(torch.as_tensor(raw[f"features.{idx}.bias"]))
                idx += 2  # conv + relu
            idx += 1  # pool
    return vgg


def vgg_loss(vgg: VGG19Features, x, y, weighted: bool = False):
    """Mean L1 over the 5 feature taps (weighted: 1/32 .. 1, summed)."""
    weights = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0) if weighted else (1.0,) * 5
    total = 0.0
    for w, a, b in zip(weights, vgg(x), vgg(y)):
        total = total + w * (a - b).abs().mean()
    return total if weighted else total / len(weights)
