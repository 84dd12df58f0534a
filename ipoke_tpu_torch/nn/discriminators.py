"""Spatial and temporal discriminators and the GAN losses (counterpart of
``ipoke_tpu/nn/discriminators.py``), channels-last.

Both discriminators return ``(logits, fmaps)``.  Every conv carries flax's
spectral norm (``blocks.SpectralNormed``): ``train=True`` advances its
stored ``u``.  Their GroupNorms keep flax's default epsilon 1e-6.  Names
repeat flax's auto-names so that ``convert.load_flax`` maps a flax tree
onto them.  The gradient penalty differentiates through the 3D
discriminator twice (``create_graph``).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv, GroupNorm, Typed, _num_groups, promote, untyped
from .motion import Conv3d

_GN_EPS = 1e-6  # flax nn.GroupNorm's default


def _gn(c: int, groups: int = None) -> GroupNorm:
    """The discriminators' GroupNorm: flax's, built without ``dtype``."""
    return untyped(GroupNorm(groups or _num_groups(c), c, eps=_GN_EPS))


class Dense(Typed, nn.Module):
    """flax ``nn.Dense``, with a bias when ``bias``; ``kernel`` is (in, out)
    as in flax."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        x, k, b = promote(self.compute_dtype, x, self.kernel, self.bias)
        y = x @ k
        return y if b is None else y + b


class PatchDiscriminator2D(nn.Module):
    """k4/s2 spectral-norm conv PatchGAN on (N, H, W, cin) frames (flow
    maps: cin 2)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, cin: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.Conv_0 = Conv(cin, ndf, 4, 2, 1, snorm=True)
        nf = ndf
        for n in range(1, n_layers):
            nf_next = ndf * min(2 ** n, 8)
            self.add_module(f"Conv_{n}", Conv(nf, nf_next, 4, 2, 1, snorm=True))
            self.add_module(f"GroupNorm_{n - 1}", _gn(nf_next))
            nf = nf_next
        nf_next = ndf * min(2 ** n_layers, 8)
        self.add_module(f"Conv_{n_layers}", Conv(nf, nf_next, 4, 1, 1, snorm=True))
        self.add_module(f"GroupNorm_{n_layers - 1}", _gn(nf_next))
        self.add_module(f"Conv_{n_layers + 1}", Conv(nf_next, 1, 4, 1, 1, snorm=True))

    def forward(self, x, train: bool = False):
        h = F.leaky_relu(self.Conv_0(x, train), 0.2)
        fmaps = [h]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"Conv_{n}")(h, train)
            h = F.leaky_relu(getattr(self, f"GroupNorm_{n - 1}")(h), 0.2)
            fmaps.append(h)
        return getattr(self, f"Conv_{self.n_layers + 1}")(h, train), fmaps


class Block3d(nn.Module):
    """Two 3x3x3 spectral-norm convs with GroupNorm, and a strided conv
    residual where the shape changes (flax name ``_Block3d_<i>``)."""

    def __init__(self, inplanes: int, planes: int,
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        k, p = (3, 3, 3), (1, 1, 1)
        self.Conv_0 = Conv3d(inplanes, planes, k, stride, p, snorm=True)
        self.GroupNorm_0 = _gn(planes)
        self.Conv_1 = Conv3d(planes, planes, k, (1, 1, 1), p, snorm=True)
        self.GroupNorm_1 = _gn(planes)
        self.has_res = tuple(stride) != (1, 1, 1) or inplanes != planes
        if self.has_res:
            self.Conv_2 = Conv3d(inplanes, planes, k, stride, p, snorm=True)
            self.GroupNorm_2 = _gn(planes)

    def forward(self, x, train: bool = False):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x, train)))
        h = self.GroupNorm_1(self.Conv_1(h, train))
        res = self.GroupNorm_2(self.Conv_2(x, train)) if self.has_res else x
        return F.relu(h + res)


class ResNet3DDiscriminator(nn.Module):
    """Temporal discriminator over (B, T, H, W, 3) windows: logits (B,
    num_classes) and the per-stage feature maps."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1, patch_temp_disc: bool = False):
        super().__init__()
        st = 1 if patch_temp_disc else 2
        self.Conv_0 = Conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), snorm=True)
        self.GroupNorm_0 = _gn(64, 16)
        blocks, stages, cin = [], [], 64
        for n_blocks, planes, (s, s_t) in zip(
                layers, (64, 128, 256, 512), ((1, 1), (1, st), (2, st), (2, st))):
            blocks.append(Block3d(cin, planes, (s_t, s, s)))
            blocks += [Block3d(planes, planes) for _ in range(n_blocks - 1)]
            stages.append(len(blocks) - 1)
            cin = planes
        for i, blk in enumerate(blocks):
            self.add_module(f"_Block3d_{i}", blk)
        self.n_blocks, self.stage_ends = len(blocks), set(stages)
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x, train: bool = False):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x, train)))
        # flax nn.max_pool pads with -inf, as max_pool3d does
        h = F.max_pool3d(h.permute(0, 4, 1, 2, 3), 3, (1, 2, 2), 1)
        h = h.permute(0, 2, 3, 4, 1)
        fmaps = []
        for i in range(self.n_blocks):
            h = getattr(self, f"_Block3d_{i}")(h, train)
            if i in self.stage_ends:
                fmaps.append(h)
        return self.Dense_0(h.mean(dim=(1, 2, 3))), fmaps


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def hinge_d_loss(pred, real: bool):
    return F.relu(1.0 - pred).mean() if real else F.relu(1.0 + pred).mean()


def bce_d_loss(pred, real: bool):
    target = 1.0 if real else 0.0
    return (torch.clamp(pred, min=0) - pred * target
            + torch.log1p(torch.exp(-pred.abs()))).mean()


def gen_loss(pred_fake, bce: bool = False):
    return bce_d_loss(pred_fake, real=True) if bce else -pred_fake.mean()


def fmap_loss(fmaps_fake, fmaps_real, loss: str = "l1"):
    total = 0.0
    for f, r in zip(fmaps_fake, fmaps_real):
        total = total + ((f - r).abs().mean() if loss == "l1"
                         else ((f - r) ** 2).mean())
    return total / len(fmaps_fake)


def gradient_penalty(disc_apply: Callable, x):
    """R1 penalty: per-sample squared norm of d sum(disc_apply(x)) / dx,
    (B,), differentiable in the discriminator's params (double backward)."""
    x = x.detach().requires_grad_()
    (grad,) = torch.autograd.grad(disc_apply(x).sum(), x, create_graph=True)
    return (grad.reshape(grad.shape[0], -1) ** 2).sum(dim=1)


def adaptive_disc_weight(nll_grad_norm, g_grad_norm, max_w: float = 1e4):
    """||grad(nll)|| / (||grad(g)|| + 1e-4), clipped to [0, max_w]."""
    return torch.clamp(nll_grad_norm / (g_grad_norm + 1e-4), 0.0, max_w)


class MinibatchDiscrimination(nn.Module):
    """Salimans et al.'s minibatch features (counterpart of
    ``ipoke_tpu/nn/discriminators.py::MinibatchDiscrimination``): each
    sample's kernel similarities exp(-L1) to the rest of the batch, appended
    to its features.  x (B, A) -> (B, A + out_features); ``T`` (A,
    out_features, kernel_dims) as flax's param."""

    def __init__(self, in_features: int, out_features: int, kernel_dims: int,
                 mean: bool = False):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.kernel_dims, self.mean = kernel_dims, mean
        self.T = nn.Parameter(torch.empty(in_features, out_features, kernel_dims))

    def forward(self, x):
        x = x.reshape(-1, self.in_features)
        m = (x @ self.T.reshape(self.in_features, -1)).reshape(
            -1, self.out_features, self.kernel_dims)
        norm = torch.abs(m[None] - m[:, None]).sum(dim=3)  # (B, B, F)
        o_b = torch.exp(-norm).sum(dim=0) - 1.0  # without the self distance
        if self.mean:
            o_b = o_b / (x.shape[0] - 1)
        return torch.cat([x, o_b], dim=1)
