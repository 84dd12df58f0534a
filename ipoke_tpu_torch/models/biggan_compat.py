"""The reference's BigGAN autoencoder, weight-compatible (counterpart of
``ipoke_tpu/models/biggan_compat.py``; reference
``models/modules/autoencoders/{big_ae,biggan}.py``): the FC fork's flow
encoder (``FCAEModel``), so that its released FCAE checkpoints can be
carried over.  ``models/big_ae.py`` is the BigAE the port trains itself.

* ``TorchResnetEncoder``: a torchvision resnet (18/34/50/101) with
  inference BatchNorm, a 1x1 ``in_conv`` for inputs of other than 3
  channels, the global average pool and a 1x1 conv head to 2 * z_dim
  (big_ae.py:130-224, ``norm: bn``).
* ``TorchBigGANDecoder64``: ``ClassUp`` (4 linears, leaky relu between,
  softmax) to a class embedding, and ``VariableDimGenerator64``
  (biggan.py:249-350): ``G_linear`` on the first split of z, 4 GBlocks of
  conditional BN and nearest 2x upsampling from 4 to 64 px, a last BN,
  relu and ``colorize``.  The self-attention block never runs at 64 px.

The modules keep the reference's state-dict key names (``encoder.model.
layer1.0.conv1.weight``, ``decoder.decoder.GBlock.0.conv0.module.weight``,
...), so that loading is ``collapse_state`` (every GANalyze spectral norm's
``weight_bar`` and ``weight_u`` to the weight its next forward uses) and
``load_state_dict``.  Inputs and outputs are NHWC like the rest of the
port; the modules run NCHW inside.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _bn(c: int, eps: float = 1e-5, affine: bool = True) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=eps, affine=affine)


class _BasicBlock(nn.Module):  # resnet18/34
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride, bias=False),
                                        _bn(planes)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class _Bottleneck(nn.Module):  # resnet50/101: the stride in the 3x3 conv
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                                        _bn(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


RESNETS = {  # torchvision stage plans
    "resnet18": (_BasicBlock, (2, 2, 2, 2)),
    "resnet34": (_BasicBlock, (3, 4, 6, 3)),
    "resnet50": (_Bottleneck, (3, 4, 6, 3)),
    "resnet101": (_Bottleneck, (3, 4, 23, 3)),
}


class _Resnet(nn.Module):
    """torchvision's feature tower, then the reference's ``fc`` head (a 1x1
    conv, ``DenseEncoderLayer``) in place of the classifier."""

    def __init__(self, kind: str, out_dim: int):
        super().__init__()
        block, plan = RESNETS[kind]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), plan)):
            blocks = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                down = j == 0 and (stride != 1 or cin != planes * block.expansion)
                blocks.append(block(cin, planes, stride, down))
                cin = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Module()
        self.fc.sub_layers = nn.Sequential(nn.Conv2d(cin, out_dim, 1))

    def forward(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
        return self.fc.sub_layers(h.mean(dim=(2, 3), keepdim=True))[:, :, 0, 0]


class TorchResnetEncoder(nn.Module):
    """[in_conv ->] resnet -> (B, 2 * z_dim); ``encode`` splits it into mu
    and logvar clamped to [-30, 10] (the reference's
    ``DiagonalGaussianDistribution``).  Keep it in eval mode: the
    BatchNorms use their running statistics."""

    def __init__(self, z_dim: int, kind: str = "resnet101", in_channels: int = 2):
        super().__init__()
        self.in_conv = nn.Conv2d(in_channels, 3, 1) if in_channels != 3 else None
        self.model = _Resnet(kind, 2 * z_dim)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.in_conv is not None:
            x = self.in_conv(x)
        return self.model(x)

    def encode(self, x):
        mu, logvar = self(x).chunk(2, dim=-1)
        return mu, torch.clamp(logvar, -30.0, 10.0)


class _SN(nn.Module):
    """A layer that the reference wraps in GANalyze's ``SpectralNorm``: its
    weight here is the collapsed one (``collapse_state``)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x):
        return self.module(x)


class _CBN(nn.Module):
    """ConditionalBatchNorm2d (biggan.py:116-130): affine-free BN (eps
    1e-4, running statistics), scaled by 1 + and shifted by linears of the
    condition."""

    def __init__(self, features: int, cond_dim: int):
        super().__init__()
        self.bn = _bn(features, 1e-4, affine=False)
        self.gamma_embed = _SN(nn.Linear(cond_dim, features, bias=False))
        self.beta_embed = _SN(nn.Linear(cond_dim, features, bias=False))

    def forward(self, x, y):
        gamma = self.gamma_embed(y) + 1.0
        return gamma[:, :, None, None] * self.bn(x) + self.beta_embed(y)[:, :, None, None]


class _GBlock(nn.Module):
    """biggan.py GBlock on the upsample path: CBN, relu, 2x nearest, 3x3
    conv, CBN, relu, 3x3 conv, plus the 2x nearest, 1x1 conv skip."""

    def __init__(self, cin: int, cout: int, cond_dim: int):
        super().__init__()
        self.conv0 = _SN(nn.Conv2d(cin, cout, 3, 1, 1))
        self.conv1 = _SN(nn.Conv2d(cout, cout, 3, 1, 1))
        self.HyperBN = _CBN(cin, cond_dim)
        self.HyperBN_1 = _CBN(cout, cond_dim)
        self.conv_sc = _SN(nn.Conv2d(cin, cout, 1))

    def forward(self, x, cond):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        out = self.conv0(up(F.relu(self.HyperBN(x, cond))))
        out = self.conv1(F.relu(self.HyperBN_1(out, cond)))
        return out + self.conv_sc(up(x))


class _Generator64(nn.Module):
    """VariableDimGenerator64: z splits into [z_dim - 40, 10, 10, 10, 10];
    ``G_linear`` of the first to 4x4x16chn, then a GBlock per split, each
    conditioned on [its split, the class embedding]."""

    def __init__(self, z_dim: int, chn: int, n_channels: int, n_class: int):
        super().__init__()
        self.z_dim, self.chn, self.n_channels = z_dim, chn, n_channels
        self.linear = nn.Linear(n_class, 128, bias=False)
        self.G_linear = _SN(nn.Linear(z_dim - 40, 4 * 4 * 16 * chn))
        widths = (16 * chn, 16 * chn, 8 * chn, 4 * chn, chn)
        self.GBlock = nn.ModuleList(_GBlock(a, b, 138) for a, b in zip(widths, widths[1:]))
        self.ScaledCrossReplicaBN = _bn(chn, 1e-4)
        self.colorize = _SN(nn.Conv2d(chn, n_channels, 3, 1, 1))

    def forward(self, z, class_probs):
        class_emb = self.linear(class_probs)
        codes = torch.split(z, [self.z_dim - 40] + [10] * 4, dim=1)
        out = self.G_linear(codes[0]).reshape(-1, 4, 4, 16 * self.chn).permute(0, 3, 1, 2)
        for i, block in enumerate(self.GBlock):
            out = block(out, torch.cat([codes[i + 1], class_emb], dim=1))
        out = self.colorize(F.relu(self.ScaledCrossReplicaBN(out)))
        out = out.permute(0, 2, 3, 1)
        return torch.tanh(out) if self.n_channels == 3 else out


class TorchBigGANDecoder64(nn.Module):
    """BigGANDecoderWrapper at 64 px: ``map_to_class_embedding`` (ClassUp:
    z -> 2 n_class -> 2 n_class -> 2 n_class -> n_class, leaky relu 0.01
    between, softmax) and the generator; NHWC out."""

    def __init__(self, z_dim: int, chn: int = 96, n_channels: int = 2,
                 n_class: int = 1000):
        super().__init__()
        dims = (z_dim, 2 * n_class, 2 * n_class, 2 * n_class, n_class)
        layers = []
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            layers += [nn.Linear(a, b)] + ([nn.LeakyReLU(0.01)] if i < 3 else [])
        self.map_to_class_embedding = nn.Module()
        self.map_to_class_embedding.main = nn.Sequential(*layers)
        self.decoder = _Generator64(z_dim, chn, n_channels, n_class)

    def forward(self, z):
        probs = torch.softmax(self.map_to_class_embedding.main(z), dim=1)
        return self.decoder(z, probs)


class BigAECompat(nn.Module):
    """The reference FCAE pair: ``encode(x) -> (mu, logvar)``, ``decode(z)
    -> a 64 px flow (or image) map``.  Build it, load a reference state
    dict (``load_torch_bigae``), keep it in eval mode."""

    def __init__(self, z_dim: int, enc_type: str = "resnet101", in_channels: int = 2,
                 chn: int = 96):
        super().__init__()
        self.z_dim = z_dim
        self.encoder = TorchResnetEncoder(z_dim, enc_type, in_channels)
        self.decoder = TorchBigGANDecoder64(z_dim, chn, in_channels)

    def encode(self, x):
        return self.encoder.encode(x)

    def decode(self, z):
        return self.decoder(z)


def _l2n(v, eps: float = 1e-4):
    return v / (np.linalg.norm(v) + eps)


def collapse_spectral_norm(w_bar: np.ndarray, u: np.ndarray) -> np.ndarray:
    """GANalyze's SpectralNorm (biggan.py:23-74): a forward runs one power
    iteration from the stored u, then divides by sigma; this is the weight
    that forward uses."""
    w = w_bar.reshape(w_bar.shape[0], -1)
    v = _l2n(w.T @ u)
    u2 = _l2n(w @ v)
    return w_bar / float(u2 @ (w @ v))


def collapse_state(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A reference state dict (numpy leaves) with every ``<layer>.module.
    weight_bar`` / ``weight_u`` / ``weight_v`` replaced by the collapsed
    ``<layer>.module.weight``."""
    out = {}
    for k, v in state.items():
        if k.endswith(".module.weight_bar"):
            p = k[:-len("weight_bar")]
            out[p + "weight"] = collapse_spectral_norm(np.asarray(v),
                                                       np.asarray(state[p + "weight_u"]))
        elif not k.endswith((".module.weight_u", ".module.weight_v")):
            out[k] = np.asarray(v)
    return out


def load_torch_bigae(model: BigAECompat, state: Dict[str, np.ndarray]) -> BigAECompat:
    """Load a reference BigAE state dict into ``model`` (keys it does not
    have, e.g. the unused self-attention's, are ignored; a BatchNorm's
    ``num_batches_tracked`` may be absent), then eval and no grad."""
    state = collapse_state(state)
    own = model.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"reference BigAE state lacks {missing[:5]}")
    model.load_state_dict({k: torch.as_tensor(state[k]) if k in state else v
                           for k, v in own.items()})
    return model.eval().requires_grad_(False)


def load_torch_bigae_npz(path: str, z_dim: int, enc_type: str = "resnet101",
                         in_channels: int = 2) -> BigAECompat:
    """An npz of a reference FCAE checkpoint's state dict (the Lightning
    ``model.`` prefix stripped) as a loaded ``BigAECompat``."""
    raw = np.load(path)
    return load_torch_bigae(BigAECompat(z_dim, enc_type, in_channels),
                            {k: raw[k] for k in raw.files})
