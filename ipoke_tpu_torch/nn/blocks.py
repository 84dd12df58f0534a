"""Conv building blocks (counterpart of ``ipoke_tpu/nn/blocks.py``).

Modules take and return NHWC tensors, like the JAX package; each conv runs
on an NCHW view of them (a channels-last NCHW tensor, so no copy).  Module
and attribute names repeat the flax names (``Conv_0``, ``GroupNorm_0``,
``Conv2dBlock_1``, ...) so that ``ipoke_tpu_torch.convert`` maps a flax tree
onto them path by path.

A compute dtype mirrors flax's ``dtype=`` with fp32 ``param_dtype``
(``set_compute_dtype``): each conv, dense and norm layer that flax builds with
``dtype`` casts its input and weights to it and returns it, while the params
stay fp32.  A layer without one promotes its input and weights to their
common type, as flax does with ``dtype=None``; a layer built so in the JAX
package (the motion encoder's and discriminators' GroupNorms, the FC
baseline's GRU cells) is marked ``untyped`` and keeps that rule.  Spectral
norm's power iteration runs in the fp32 of the weight and its ``u``, before
the cast (flax's ``SpectralNorm`` has no dtype of its own there).

Spectral norm follows flax's ``nn.SpectralNorm``, not
``torch.nn.utils.spectral_norm``: a conv built with ``snorm`` keeps a buffer
``u`` (1, out) and ``sigma``, and every call runs one power-iteration step
from the stored ``u`` over the kernel as a (-1, out) matrix, in train and
eval alike; only ``train=True`` stores the new ``u`` and ``sigma``.  Frozen
nets built without ``snorm`` take the collapsed weight (``convert``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spade_gn import spade_gn_modulate


def get_activation(name: str):
    return {"elu": F.elu, "relu": F.relu, "tanh": torch.tanh, "none": None}[name]


class Typed:
    """A layer that takes a compute dtype: ``compute_dtype`` (None: promote)
    unless built ``untyped``."""

    takes_dtype = True
    compute_dtype = None


def untyped(module: nn.Module) -> nn.Module:
    """``module`` marked as built without ``dtype`` in the JAX package:
    ``set_compute_dtype`` passes it by."""
    module.takes_dtype = False
    return module


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of every typed layer of ``module`` (flax's
    ``dtype``; None promotes); params are untouched."""
    for m in module.modules():
        if getattr(m, "takes_dtype", False):
            m.compute_dtype = dtype
    return module


def promote(dtype, x, *params):
    """flax's ``promote_dtype``: ``x`` and ``params`` cast to ``dtype``, or
    without one to their common type (None entries pass)."""
    if dtype is None:
        dtype = x.dtype
        for p in params:
            if p is not None:
                dtype = torch.promote_types(dtype, p.dtype)
    return [None if t is None else t.to(dtype) for t in (x, *params)]


def _num_groups(channels: int, max_groups: int = 16) -> int:
    g = min(channels, max_groups)
    while channels % g != 0:
        g -= 1
    return g


class GroupNorm(Typed, nn.Module):
    """flax ``nn.GroupNorm`` on channels-last tensors (NHWC, or NTHWC with the
    statistics over all non-batch axes): fp32 statistics with the fast variance
    max(E[x^2] - E[x]^2, 0), normalise, scale and shift in fp32, one cast at
    the end: to the compute dtype, else to the common type of the input and
    the scale and bias (flax's ``_normalize``)."""

    def __init__(self, num_groups: int, channels: int, affine: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        if affine:
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.scale = self.bias = None

    def forward(self, x):
        return group_norm(x, self.num_groups, self.scale, self.bias, self.eps,
                          self.compute_dtype)


def group_norm(x, num_groups: int, scale=None, bias=None, eps: float = 1e-5,
               compute_dtype=None):
    """``GroupNorm``'s computation on a channels-last ``x`` with the given
    scale and bias (None: no affine)."""
    c, g = x.shape[-1], num_groups
    xg = x.float().reshape(x.shape[0], -1, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = compute_dtype or x.dtype
    if scale is not None:
        y = y * scale.float() + bias.float()
        if compute_dtype is None:
            out = torch.promote_types(out, scale.dtype)
    return y.to(out)


def _l2_normalize(x, eps: float = 1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormed(nn.Module):
    """Base of the convs that may carry flax's spectral norm.  ``weight_t``
    is the weight as an (out, -1) matrix: the transpose of flax's (-1, out)
    kernel up to a permutation of its rows, which changes neither sigma nor
    the power iteration."""

    def _init_snorm(self, snorm: bool, cout: int) -> None:
        self.snorm = snorm
        if snorm:
            self.register_buffer("u", torch.randn(1, cout))
            self.register_buffer("sigma", torch.ones(()))

    def weight_t(self):
        return self.weight.reshape(self.weight.shape[0], -1)

    def normed_weight(self, train: bool):
        """The weight over sigma from one power-iteration step from ``u``
        (no gradient through u and v); with ``train`` the new u and sigma are
        stored as new tensors, since autograd may hold the old ``u``."""
        if not self.snorm:
            return self.weight
        wt = self.weight_t()
        with torch.no_grad():
            v = _l2_normalize(self.u @ wt)
            u = _l2_normalize(v @ wt.t())
        sigma = ((v @ wt.t()) @ u.t())[0, 0]
        w = self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if train:
            self.u, self.sigma = u, sigma.detach()
        return w


def make_norm(name: Optional[str], channels: int) -> Optional[nn.Module]:
    if name == "none":
        return None
    if name == "group":
        return GroupNorm(_num_groups(channels), channels)
    if name == "in":  # instance norm: one channel per group, no scale/shift
        return GroupNorm(channels, channels, affine=False)
    raise ValueError(f"unsupported norm {name!r}")


class Conv(Typed, SpectralNormed):
    """flax ``nn.Conv`` with symmetric integer padding, on NHWC tensors.
    ``weight`` is OIHW (converted from flax's HWIO kernel)."""

    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1,
                 padding: int = 0, bias: bool = True, snorm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, ks, ks))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self._init_snorm(snorm, cout)

    def forward(self, x, train: bool = False):
        x, w, b = promote(self.compute_dtype, x, self.normed_weight(train), self.bias)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


def _same_transpose_start(ks: int, st: int) -> int:
    """Where lax's ``conv_transpose(..., "SAME")`` window starts in the full
    transposed conv: k - 1 minus its left padding (lax's
    ``_conv_transpose_padding``)."""
    pad_a = ks - 1 if st > ks - 1 else -(-(ks + st - 2) // 2)
    return ks - 1 - pad_a


class ConvTranspose(Typed, SpectralNormed):
    """flax ``nn.ConvTranspose(ks, st)`` on NHWC tensors, ``weight`` (in, out,
    kh, kw).  By default ``"SAME"`` with ``transpose_kernel=False``:
    ``F.conv_transpose2d`` with the spatially flipped kernel (weight =
    flip(kernel, (0, 1)).permute(2, 3, 0, 1)), its full output cut to lax's
    window of in * st (zero rows at the end where the kernel is shorter than
    the stride), then the bias.  ``torch_crop`` (the reference's layers,
    ``architecture.torch_compat``): ``"VALID"`` with
    ``transpose_kernel=True``, then ``[1:, 1:]``, the kernel transposed, not
    flipped; at k3 s2 that is torch's ``ConvTranspose2d(k3, s2, p=1,
    output_padding=1)``."""

    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 2,
                 snorm: bool = False, torch_crop: bool = False):
        super().__init__()
        self.ks, self.stride, self.torch_crop = ks, stride, torch_crop
        self.weight = nn.Parameter(torch.empty(cin, cout, ks, ks))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._init_snorm(snorm, cout)

    def weight_t(self):  # u runs over the out features
        return self.weight.transpose(0, 1).reshape(self.weight.shape[1], -1)

    def forward(self, x, train: bool = False):
        x, w, b = promote(self.compute_dtype, x, self.normed_weight(train), self.bias)
        return conv_transpose(x, w, b, self.ks, self.stride, self.torch_crop)


def conv_transpose(x, w, b, ks: int, stride: int, torch_crop: bool = False):
    """``ConvTranspose``'s computation on an NHWC ``x`` with its (in, out,
    kh, kw) ``w`` and bias ``b``."""
    h, wd, s = x.shape[1], x.shape[2], stride
    short = max(s - ks, 0)  # rows the full output lacks (k < s)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None if short else b, stride=s)
    if torch_crop:
        y = y[:, :, 1:, 1:]
    else:
        a = _same_transpose_start(ks, s)
        y = y[:, :, a:a + h * s, a:a + wd * s]
        if short:
            y = F.pad(y, (0, short, 0, short)) + b[:, None, None]
    return y.permute(0, 2, 3, 1)


class ConvTransposeTK(Typed, nn.Module):
    """flax ``nn.ConvTranspose(k, s, "VALID", transpose_kernel=True)``
    without bias, cropped by ``padding`` on every side, on NHWC tensors:
    torch's ``ConvTranspose2d(k, s, padding, bias=False)``.  ``weight`` is (in, out, kh, kw),
    flax's (kh, kw, out, in) kernel transposed, not flipped."""

    def __init__(self, cin: int, cout: int, ks: int = 4, stride: int = 2,
                 padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cin, cout, ks, ks))

    def forward(self, x):
        x, w = promote(self.compute_dtype, x, self.weight)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, None,
                               stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` on channels-last
    tensors: (x - mean) * (scale * rsqrt(var + eps)) + bias, the running
    statistics as buffers (flax's ``batch_stats``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        return (x - self.mean) * (self.scale * torch.rsqrt(self.var + self.eps)) \
            + self.bias


class Conv2dBlock(nn.Module):
    """conv -> norm -> activation."""

    def __init__(self, cin: int, out_dim: int, ks: int = 3, st: int = 1,
                 padding: int = 0, norm: str = "none", activation: str = "elu",
                 use_bias: bool = True, snorm: bool = False):
        super().__init__()
        self.Conv_0 = Conv(cin, out_dim, ks, st, padding, use_bias, snorm)
        self.GroupNorm_0 = make_norm(norm, out_dim)
        self.act = get_activation(activation)

    def forward(self, x, train: bool = False):
        x = self.Conv_0(x, train)
        if self.GroupNorm_0 is not None:
            x = self.GroupNorm_0(x)
        return self.act(x) if self.act is not None else x


class Conv2dTransposeBlock(nn.Module):
    """``st``x upsampling transpose conv -> norm -> activation; under
    ``torch_crop`` the reference's layer, whose "elu" is a ReLU."""

    def __init__(self, cin: int, out_dim: int, ks: int = 3, st: int = 2,
                 norm: str = "none", activation: str = "elu",
                 snorm: bool = False, torch_crop: bool = False):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, out_dim, ks, st, snorm, torch_crop)
        self.GroupNorm_0 = make_norm(norm, out_dim)
        if torch_crop and activation == "elu":
            activation = "relu"
        self.act = get_activation(activation)

    def forward(self, x, train: bool = False):
        x = self.ConvTranspose_0(x, train)
        if self.GroupNorm_0 is not None:
            x = self.GroupNorm_0(x)
        return self.act(x) if self.act is not None else x


class ResBlock(nn.Module):
    """Two-conv residual block, optional stride-2 down or transpose-conv up.
    Children carry flax's auto-names in creation order."""

    def __init__(self, dim_in: int, dim_out: int, norm: str = "group",
                 activation: str = "elu", upsampling: bool = False,
                 stride: int = 1, snorm: bool = False, torch_crop: bool = False):
        super().__init__()
        self.upsampling = upsampling
        sn = dict(snorm=snorm)
        if upsampling:
            up = dict(sn, torch_crop=torch_crop)
            self.Conv2dTransposeBlock_0 = Conv2dTransposeBlock(
                dim_in, dim_out, 3, 2, norm=norm, activation=activation, **up)
            self.Conv2dBlock_0 = Conv2dBlock(dim_out, dim_out, 3, 1, 1, norm=norm,
                                             activation="none", **sn)
            self.Conv2dTransposeBlock_1 = Conv2dTransposeBlock(
                dim_in, dim_out, 3, 2, norm="in", activation=activation, **up)
        else:
            self.Conv2dBlock_0 = Conv2dBlock(dim_in, dim_out, 3, stride, 1,
                                             norm=norm, activation=activation, **sn)
            self.Conv2dBlock_1 = Conv2dBlock(dim_out, dim_out, 3, 1, 1, norm=norm,
                                             activation="none", **sn)
            if dim_in != dim_out or stride != 1:
                self.Conv2dBlock_2 = Conv2dBlock(dim_in, dim_out, 3, stride, 1,
                                                 norm="in", activation=activation,
                                                 **sn)

    def forward(self, x, train: bool = False):
        """The convs in the JAX package's order (each spectral norm's stats
        advance once per call with ``train``)."""
        if self.upsampling:
            h = self.Conv2dBlock_0(self.Conv2dTransposeBlock_0(x, train), train)
            return h + self.Conv2dTransposeBlock_1(x, train)
        h = self.Conv2dBlock_1(self.Conv2dBlock_0(x, train), train)
        residual = self.Conv2dBlock_2(x, train) \
            if hasattr(self, "Conv2dBlock_2") else x
        return h + residual


class NormConv2d(Typed, nn.Module):
    """The JAX package's ``NormConv2d`` on NHWC tensors: the kernel ``v``
    (HWIO, as flax stores it) over its l2 norm per output channel plus
    1e-12, then gamma * conv + beta, with explicit stride and symmetric
    padding."""

    def __init__(self, cin: int, out_dim: int, ks: int = 3, st: int = 1,
                 padding: int = 0):
        super().__init__()
        self.st, self.padding = st, padding
        self.v = nn.Parameter(torch.empty(ks, ks, cin, out_dim))
        self.gamma = nn.Parameter(torch.ones(out_dim))
        self.beta = nn.Parameter(torch.zeros(out_dim))

    def init_random(self, generator) -> None:
        """flax's init: v ~ N(0, 0.05^2), gamma 1, beta 0."""
        self.v.normal_(0.0, 0.05, generator=generator)
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x):
        w = self.v / (torch.sqrt(torch.sum(self.v ** 2, dim=(0, 1, 2))) + 1e-12)
        dt = self.compute_dtype
        x, w = x.to(dt or x.dtype), w.to(dt or w.dtype)  # as flax's astype
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=self.st, padding=self.padding)
        return self.gamma * y.permute(0, 2, 3, 1) + self.beta


def resize_bilinear(y, height: int, width: int):
    """``jax.image.resize(..., "bilinear")`` on NHWC: half-pixel centres and,
    when downscaling, an antialiasing (triangle) filter.  Computed in fp32
    (the antialiased filter has no bf16 CPU kernel), cast back once."""
    out = F.interpolate(y.permute(0, 3, 1, 2).float(), size=(height, width),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).to(y.dtype)


def resize_bilinear_align_corners(y, height: int, width: int):
    """The JAX package's ``resize_bilinear_align_corners`` on NHWC: torch's
    ``F.interpolate(..., align_corners=True)`` (output pixel i samples input
    coordinate i * (in - 1) / (out - 1)), no antialiasing."""
    out = F.interpolate(y.permute(0, 3, 1, 2), size=(height, width),
                        mode="bilinear", align_corners=True)
    return out.permute(0, 2, 3, 1)


class Spade(nn.Module):
    """SPADE conditioning: parameter-free GroupNorm modulated by gamma/beta
    convs over the resized conditioning image.  ``modulation`` depends only on
    the conditioning image, so a T-frame decode computes it once per clip."""

    def __init__(self, num_features: int, cond_channels: int = 3,
                 hidden: int = 128, align_corners: bool = False):
        super().__init__()
        self.num_features = num_features
        self.resize = resize_bilinear_align_corners if align_corners \
            else resize_bilinear
        self.Conv_0 = Conv(cond_channels, hidden, 3, 1, 1)
        self.Conv_1 = Conv(hidden, num_features, 3, 1, 1)
        self.Conv_2 = Conv(hidden, num_features, 3, 1, 1)

    def modulation(self, y, height: int, width: int):
        y = F.leaky_relu(self.Conv_0(self.resize(y, height, width)), 0.2)
        return self.Conv_1(y), self.Conv_2(y)

    def forward(self, x, mod):
        gamma, beta = mod
        return spade_gn_modulate(x, gamma, beta, _num_groups(self.num_features),
                                 1e-5)


class AdaIN(nn.Module):
    """Instance norm of (B, T, H, W, C) over (T, H, W), modulated by
    (1 + gamma) and beta from a Dense layer on leaky_relu(z, 0.2)
    (counterpart of ``ipoke_tpu/nn/blocks.py::AdaIN``, the 3D ADAIN of the
    alternative motion generator): two-pass variance, eps 1e-5."""

    def __init__(self, num_features: int, z_dim: int):
        super().__init__()
        from .discriminators import Dense

        self.Dense_0 = Dense(z_dim, 2 * num_features, bias=True)

    def forward(self, x, z):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        out = (x - mean) * torch.rsqrt(var + 1e-5)
        gamma, beta = torch.chunk(self.Dense_0(F.leaky_relu(z, 0.2)), 2, dim=-1)
        return (1.0 + gamma[:, None, None, None, :]) * out + beta[:, None, None, None, :]
