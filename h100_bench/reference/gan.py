"""Plain PyTorch discriminators, VGG19 taps and GAN losses of the first
stage (``ipoke_tpu_torch/nn/discriminators.py``, ``nn/vgg.py``), NHWC,
fp32, with the port's names.  Every discriminator conv carries flax's
spectral norm."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .motion import Conv3d, gn
from .nets import ZERO, Conv


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))

    def init_rule(self, name, t):
        return ("normal", t.shape[0] ** -0.5) if name == "kernel" else ZERO

    def forward(self, x):
        return x @ self.kernel


class PatchDiscriminator2D(nn.Module):
    """k4/s2 PatchGAN over frames: (logits, feature maps)."""

    def __init__(self, ndf=64, n_layers=3, cin=3):
        super().__init__()
        self.n_layers = n_layers
        self.Conv_0 = Conv(cin, ndf, 4, 2, 1, snorm=True)
        nf = ndf
        for n in range(1, n_layers):
            nf_next = ndf * min(2 ** n, 8)
            self.add_module(f"Conv_{n}", Conv(nf, nf_next, 4, 2, 1, snorm=True))
            self.add_module(f"GroupNorm_{n - 1}", gn(nf_next))
            nf = nf_next
        nf_next = ndf * min(2 ** n_layers, 8)
        self.add_module(f"Conv_{n_layers}", Conv(nf, nf_next, 4, 1, 1, snorm=True))
        self.add_module(f"GroupNorm_{n_layers - 1}", gn(nf_next))
        self.add_module(f"Conv_{n_layers + 1}", Conv(nf_next, 1, 4, 1, 1, snorm=True))

    def forward(self, x, train=False):
        h = F.leaky_relu(self.Conv_0(x, train), 0.2)
        fmaps = [h]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"Conv_{n}")(h, train)
            h = F.leaky_relu(getattr(self, f"GroupNorm_{n - 1}")(h), 0.2)
            fmaps.append(h)
        return getattr(self, f"Conv_{self.n_layers + 1}")(h, train), fmaps


class Block3d(nn.Module):
    def __init__(self, inplanes, planes, stride=(1, 1, 1)):
        super().__init__()
        k, p = (3, 3, 3), (1, 1, 1)
        self.Conv_0 = Conv3d(inplanes, planes, k, stride, p, snorm=True)
        self.GroupNorm_0 = gn(planes)
        self.Conv_1 = Conv3d(planes, planes, k, (1, 1, 1), p, snorm=True)
        self.GroupNorm_1 = gn(planes)
        self.has_res = tuple(stride) != (1, 1, 1) or inplanes != planes
        if self.has_res:
            self.Conv_2 = Conv3d(inplanes, planes, k, stride, p, snorm=True)
            self.GroupNorm_2 = gn(planes)

    def forward(self, x, train=False):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x, train)))
        h = self.GroupNorm_1(self.Conv_1(h, train))
        res = self.GroupNorm_2(self.Conv_2(x, train)) if self.has_res else x
        return F.relu(h + res)


class ResNet3DDiscriminator(nn.Module):
    """Temporal discriminator over (B, T, H, W, 3) windows: (logits (B, 1),
    the feature map at the end of each stage)."""

    def __init__(self, layers=(1, 1, 1, 1)):
        super().__init__()
        self.Conv_0 = Conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), snorm=True)
        self.GroupNorm_0 = gn(64, 16)
        blocks, stages, cin = [], [], 64
        for n_blocks, planes, (s, s_t) in zip(layers, (64, 128, 256, 512),
                                               ((1, 1), (1, 2), (2, 2), (2, 2))):
            blocks.append(Block3d(cin, planes, (s_t, s, s)))
            blocks += [Block3d(planes, planes) for _ in range(n_blocks - 1)]
            stages.append(len(blocks) - 1)
            cin = planes
        for i, blk in enumerate(blocks):
            self.add_module(f"_Block3d_{i}", blk)
        self.n_blocks, self.stage_ends = len(blocks), set(stages)
        self.Dense_0 = Dense(cin, 1)

    def forward(self, x, train=False):
        h = F.relu(self.GroupNorm_0(self.Conv_0(x, train)))
        h = F.max_pool3d(h.permute(0, 4, 1, 2, 3), 3, (1, 2, 2), 1).permute(0, 2, 3, 4, 1)
        fmaps = []
        for i in range(self.n_blocks):
            h = getattr(self, f"_Block3d_{i}")(h, train)
            if i in self.stage_ends:
                fmaps.append(h)
        return self.Dense_0(h.mean(dim=(1, 2, 3))), fmaps


VGG_CFG = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 1))


class VGG19Features(nn.Module):
    """relu1_1 .. relu5_1 of an NHWC batch in [-1, 1] (no normalisation)."""

    def __init__(self, cin=3):
        super().__init__()
        for b, (ch, n) in enumerate(VGG_CFG):
            for c in range(n):
                self.add_module(f"conv{b + 1}_{c + 1}", Conv(cin, ch, 3, 1, 1))
                cin = ch

    def forward(self, x):
        taps = []
        for b, (_, n) in enumerate(VGG_CFG):
            for c in range(n):
                x = F.relu(getattr(self, f"conv{b + 1}_{c + 1}")(x))
                if c == 0:
                    taps.append(x)
            if b < len(VGG_CFG) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return taps


def vgg_loss(vgg, x, y):
    """Mean over the five taps of the mean L1 between x's and y's."""
    return sum((a - b).abs().mean() for a, b in zip(vgg(x), vgg(y))) / len(VGG_CFG)


def hinge_d_loss(pred, real):
    return F.relu(1.0 - pred).mean() if real else F.relu(1.0 + pred).mean()


def gen_loss(pred_fake):
    return -pred_fake.mean()


def fmap_loss(fake, real):
    return sum((f - r).abs().mean() for f, r in zip(fake, real)) / len(fake)


def gradient_penalty(disc, x):
    """R1: per-sample squared norm of d sum(disc(x)) / dx, differentiable in
    the discriminator's params."""
    x = x.detach().requires_grad_()
    (grad,) = torch.autograd.grad(disc(x).sum(), x, create_graph=True)
    return (grad.reshape(grad.shape[0], -1) ** 2).sum(dim=1)


def kl_loss(mu, logvar):
    return -0.5 * torch.mean(torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))
