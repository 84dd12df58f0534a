"""LPIPS with learned linear heads (counterpart of ``ipoke_tpu/nn/lpips.py``;
reference ``models/modules/autoencoders/LPIPS.py:12-60`` + ``vgg16.py``).

ScalingLayer -> torchvision-VGG16 feature slices tapped after the last ReLU
of each block (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3) -> unit
normalisation over channels (eps 1e-10) -> squared difference -> 1x1 head
-> spatial mean -> sum over taps.  A 2-channel flow is zero-padded to 3
channels before the shift and scale.  NHWC in [-1, 1], as in the JAX
package.

Weights: a converted torch LPIPS state_dict (``load_torch_lpips_npz``; the
diversity test reads ``IPOKE_LPIPS_WEIGHTS``), the JAX package's params
(``convert.load_lpips``), or a fixed-seed draw (``init_lpips``: fan-in
normal convs from a CPU generator, heads |N(0, 1)| / C from numpy's seeded
generator, as the JAX package draws its heads).  Nothing is downloaded.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv

# torchvision vgg16.features: (out_channels, n_convs) per block, the feature
# index of each conv, and the slice bounds of the reference's five slices
_VGG16_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_CHNS = (64, 128, 256, 512, 512)
_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SLICE_BOUNDS = (0, 4, 9, 16, 23, 30)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The tap after the last conv's ReLU of each block, NHWC."""

    def __init__(self, cin: int = 3):
        super().__init__()
        for b, (ch, n_convs) in enumerate(_VGG16_CFG):
            for c in range(n_convs):
                self.add_module(f"conv{b + 1}_{c + 1}", Conv(cin, ch, 3, 1, 1))
                cin = ch

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for b, (_, n_convs) in enumerate(_VGG16_CFG):
            for c in range(n_convs):
                x = F.relu(getattr(self, f"conv{b + 1}_{c + 1}")(x))
            taps.append(x)
            if b < len(_VGG16_CFG) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return taps


def _normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt((x * x).sum(dim=-1, keepdim=True)) + eps)


def _pad3(x):
    if x.shape[-1] == 2:
        return torch.cat([x, x.new_zeros((*x.shape[:-1], 1))], dim=-1)
    return x


class LPIPS(nn.Module):
    """``vgg`` (VGG16Features) and ``lins``, the five (C,) heads."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.lins = nn.ParameterList([nn.Parameter(torch.empty(c)) for c in _CHNS])
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def features(self, x) -> List[torch.Tensor]:
        """The channel-normalised tap stack of one image batch: computed once
        per sample, paired by ``from_features``."""
        taps = self.vgg((_pad3(x) - self.shift) / self.scale)
        return [_normalize(t) for t in taps]

    def from_features(self, fa, fb):
        total = 0.0
        for w, xa, xb in zip(self.lins, fa, fb):
            total = total + (((xa - xb) ** 2) @ w).mean(dim=(1, 2))
        return total

    def forward(self, a, b):
        """(B,) distance of (B, H, W, C) images in [-1, 1], C in {2, 3}."""
        return self.from_features(self.features(a), self.features(b))


def init_lpips(seed: int = 0, device="cpu") -> LPIPS:
    """The fixed-seed LPIPS on ``device``: convs from a CPU generator seeded
    ``seed`` (the same weights on every device; the values are not JAX's),
    heads |N(0, 1)| / C from ``np.random.default_rng(seed)``."""
    from ..entry import materialize

    with torch.device("meta"):
        net = LPIPS()
    net = materialize(net, "cpu", torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for w, c in zip(net.lins, _CHNS):
            w.copy_(torch.as_tensor(np.abs(rng.normal(size=c)) / c))
        net.shift.copy_(torch.tensor(_SHIFT))
        net.scale.copy_(torch.tensor(_SCALE))
    return net.to(device).eval().requires_grad_(False)


def load_torch_lpips_npz(path: str, device="cpu") -> LPIPS:
    """A dumped torch LPIPS state_dict (.npz: ``net.slice{s}.{i}.weight`` /
    ``.bias`` at torchvision's feature indices, ``lin{k}.model.1.weight``
    (1, C, 1, 1)) as the port's LPIPS on ``device``."""
    raw = np.load(path)
    net = init_lpips(0)
    idx = iter(_CONV_IDX)
    with torch.no_grad():
        for b, (_, n_convs) in enumerate(_VGG16_CFG):
            for c in range(n_convs):
                i = next(idx)
                s = int(np.searchsorted(_SLICE_BOUNDS, i, side="right"))
                conv = getattr(net.vgg, f"conv{b + 1}_{c + 1}")
                conv.weight.copy_(torch.as_tensor(raw[f"net.slice{s}.{i}.weight"]))
                conv.bias.copy_(torch.as_tensor(raw[f"net.slice{s}.{i}.bias"]))
        for k, w in enumerate(net.lins):
            w.copy_(torch.as_tensor(raw[f"lin{k}.model.1.weight"][0, :, 0, 0]))
    return net.to(device)
