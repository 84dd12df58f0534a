"""I3D (Inflated Inception-3D, Kinetics-400) for FVD (counterpart of
``ipoke_tpu/eval/i3d.py``; reference ``utils/metrics.py:919-1170``).

Videos (B, T, H, W, 3) in [-1, 1], channels-last as in the JAX package;
each conv is ``F.conv3d`` (cuDNN on the card).  Padding is TF/flax
``'SAME'``: per axis total = max((ceil(n/s) - 1) s + k - n, 0), the low side
total // 2 and the rest high, so the stride-2 stem and pools pad
asymmetrically (``F.pad``, not ``padding=``); max pools pad with -inf.
BatchNorm is inference-only with eps 1e-3.  Names repeat flax's, so
``convert.load_flax`` maps the JAX package's variables onto the net.

Weights: a converted kinetics state dict (``load_torch_i3d_npz``, named by
``IPOKE_I3D_WEIGHTS``) or a fixed-seed draw (``init_i3d``: fan-in normal
convs and dense kernel, unit BN, from a CPU generator; the values are not
JAX's).
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import BatchNorm
from ..nn.motion import Conv3d


def _same_pads(sizes, kernel, stride):
    """F.pad's argument (last axis first) for flax 'SAME' over ``sizes``."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for lo_hi in reversed(pads) for p in lo_hi]


class SameConv3d(Conv3d):
    """``Conv3d`` (no bias, OIDHW) with flax 'SAME' padding and strides."""

    def __init__(self, cin, cout, ks, stride=(1, 1, 1)):
        super().__init__(cin, cout, ks, stride)
        self.ks = tuple(ks)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        x = F.pad(x, _same_pads(x.shape[2:], self.ks, self.stride))
        return F.conv3d(x, self.weight, None, stride=self.stride).permute(0, 2, 3, 4, 1)


def max_pool_same(x, kernel, stride):
    """flax ``max_pool(..., padding='SAME')`` on (B, T, H, W, C): -inf pads."""
    x = x.permute(0, 4, 1, 2, 3)
    x = F.pad(x, _same_pads(x.shape[2:], kernel, stride), value=float("-inf"))
    return F.max_pool3d(x, kernel, stride).permute(0, 2, 3, 4, 1)


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1)):
        super().__init__()
        self.conv3d = SameConv3d(cin, cout, kernel, stride)
        self.batch3d = BatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.batch3d(self.conv3d(x)))


class Mixed(nn.Module):
    """Four branches: 1x1x1; 1x1x1 -> 3x3x3; 1x1x1 -> 3x3x3; 3x3x3 max pool
    (stride 1) -> 1x1x1; concatenated over channels."""

    def __init__(self, cin: int, oc: Sequence[int]):
        super().__init__()
        self.branch_0 = Unit3D(cin, oc[0])
        self.branch_1a = Unit3D(cin, oc[1])
        self.branch_1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.branch_2a = Unit3D(cin, oc[3])
        self.branch_2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.branch_3b = Unit3D(cin, oc[5])
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x):
        b3 = self.branch_3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.branch_0(x), self.branch_1b(self.branch_1a(x)),
                          self.branch_2b(self.branch_2a(x)), b3], dim=-1)


class Linear(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out) and ``bias``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


_MIXED: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("mixed_5c", (384, 192, 384, 48, 128, 128)),
)


class I3D(nn.Module):
    """Kinetics-400 logits over 1024-d pooled features."""

    def __init__(self):
        super().__init__()
        self.conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.conv3d_2b_1x1 = Unit3D(64, 64)
        self.conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, oc in _MIXED:
            mixed = Mixed(cin, oc)
            self.add_module(name, mixed)
            cin = mixed.out_channels
        self.logits = Linear(cin, 400)

    def forward(self, x, return_features: bool = False):
        """Logits (B, 400) of (B, T, H, W, 3) clips in [-1, 1]; with
        ``return_features`` also the 1024-d pooled features."""
        out = self.conv3d_1a_7x7(x)
        out = max_pool_same(out, (1, 3, 3), (1, 2, 2))
        out = self.conv3d_2c_3x3(self.conv3d_2b_1x1(out))
        out = max_pool_same(out, (1, 3, 3), (1, 2, 2))
        for name, _ in _MIXED:
            if name == "mixed_4b":
                out = max_pool_same(out, (3, 3, 3), (2, 2, 2))
            elif name == "mixed_5b":
                out = max_pool_same(out, (2, 2, 2), (2, 2, 2))
            out = getattr(self, name)(out)
        feats = out.mean(dim=(1, 2, 3))
        logits = self.logits(feats)
        return (logits, feats) if return_features else logits


def init_i3d(seed: int = 0, device="cpu") -> I3D:
    """The converted kinetics I3D when ``IPOKE_I3D_WEIGHTS`` names one (as
    the JAX package's ``init_i3d_params``), else fixed-seed random weights
    from a CPU generator (the same on every device); eval, no grad."""
    path = os.environ.get("IPOKE_I3D_WEIGHTS")
    if path:
        return load_torch_i3d_npz(path, device)
    from ..entry import materialize

    with torch.device("meta"):
        net = I3D()
    gen = torch.Generator().manual_seed(seed)
    net = materialize(net, "cpu", gen)
    with torch.no_grad():
        for sub in net.modules():
            if isinstance(sub, BatchNorm):
                sub.scale.fill_(1.0)
                sub.bias.zero_()
                sub.mean.zero_()
                sub.var.fill_(1.0)
            elif isinstance(sub, Linear):
                sub.kernel.normal_(0.0, sub.kernel.shape[0] ** -0.5, generator=gen)
                sub.bias.zero_()
    return net.to(device).eval().requires_grad_(False)


@torch.no_grad()
def i3d_activations(net: I3D, videos, batch_size: int = 8) -> np.ndarray:
    """The (N, 400) logits of ``videos`` (N, T, H, W, 3) in [-1, 1], tensors
    or arrays, in chunks of ``batch_size`` (the FVD features, reference
    ``utils/metrics.py:780-793``); the last short chunk goes through too."""
    dev = next(net.parameters()).device
    outs = []
    for i in range(0, videos.shape[0], batch_size):
        chunk = torch.as_tensor(videos[i:i + batch_size]).to(dev, torch.float32)
        outs.append(net(chunk).cpu().numpy())
    return np.concatenate(outs)


_BRANCH_MAP = {("branch_1", "0"): "branch_1a", ("branch_1", "1"): "branch_1b",
               ("branch_2", "0"): "branch_2a", ("branch_2", "1"): "branch_2b",
               ("branch_3", "1"): "branch_3b"}
_BN_NAMES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
             "running_var": "var"}


def load_torch_i3d_npz(path: str, device="cpu") -> I3D:
    """A dumped torch kinetics I3D state dict (.npz; the reference's names:
    ``conv3d_1a_7x7.conv3d.weight`` OIDHW, ``...batch3d.{weight, bias,
    running_mean, running_var}``, ``mixed_*.branch_1.0...`` Sequential
    branches, the ``conv3d_0c_1x1`` 1x1x1 head with bias) as the port's I3D
    on ``device``."""
    raw = np.load(path)
    with torch.device("meta"):
        net = I3D()
    net = net.to_empty(device="cpu")
    own = dict(net.named_parameters())
    own.update(net.named_buffers())
    seen = set()
    for key in raw.files:
        parts = key.split(".")
        renamed, i = [], 0
        while i < len(parts):
            if tuple(parts[i:i + 2]) in _BRANCH_MAP:
                renamed.append(_BRANCH_MAP[tuple(parts[i:i + 2])])
                i += 2
            else:
                renamed.append(parts[i])
                i += 1
        val = raw[key]
        if renamed[0] == "conv3d_0c_1x1":
            # the 1x1x1 head with bias == the dense layer on pooled features
            if renamed[-1] == "weight":
                name, val = "logits.kernel", val[:, :, 0, 0, 0].T
            elif renamed[-1] == "bias":
                name = "logits.bias"
            else:
                continue
        elif renamed[-2] == "conv3d" and renamed[-1] == "weight":
            name = ".".join(renamed)
        elif renamed[-2] == "batch3d" and renamed[-1] in _BN_NAMES:
            name = ".".join(renamed[:-1] + [_BN_NAMES[renamed[-1]]])
        else:
            continue
        with torch.no_grad():
            own[name].copy_(torch.as_tensor(np.ascontiguousarray(val)))
        seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"{path}: no values for {missing[:4]}...")
    return net.to(device).eval().requires_grad_(False)
