"""Plain PyTorch conv nets of the iPOKE first stage and its frozen encoders,
NHWC: the math of ``ipoke_tpu_torch/nn/blocks.py``, ``nn/encoders.py``,
``nn/gru.py``, ``nn/motion.py`` and ``models/first_stage.py`` written out
again in fp32, without kernels, compute dtypes or options the benchmark's
configurations do not set.  Module and parameter names repeat the port's,
so one state dict loads into both.

Each module that owns parameters says how the benchmark draws them
(``init_rule``, read by ``specs``), as the port's ``entry._init_random``
draws them: fan-in scaled normal conv and dense weights, zero biases, unit
GroupNorm scales, N(0, 1) motion bias and spectral-norm ``u``, sigma 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ZERO, ONE = ("const", 0.0), ("const", 1.0)


def specs(root: nn.Module, prefix: str = ""):
    """(key, shape, rule) of every parameter and buffer under ``root``."""
    out = []
    for mname, m in root.named_modules(prefix=prefix.rstrip(".")):
        own = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        own = [(n, t) for n, t in own if t is not None]
        if own and not hasattr(m, "init_rule"):
            raise TypeError(f"{type(m).__name__} at {mname!r} has no init_rule")
        for n, t in own:
            out.append((f"{mname}.{n}" if mname else n, tuple(t.shape), m.init_rule(n, t)))
    return out


def num_groups(channels: int, max_groups: int = 16) -> int:
    g = min(channels, max_groups)
    while channels % g != 0:
        g -= 1
    return g


def group_norm(x, groups: int, scale=None, bias=None, eps: float = 1e-5):
    """GroupNorm over every non-batch axis of a channels-last tensor."""
    c = x.shape[-1]
    xg = x.reshape(x.shape[0], -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return y if scale is None else y * scale + bias


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def init_rule(self, name, t):
        return ONE if name == "scale" else ZERO

    def forward(self, x):
        return group_norm(x, self.groups, self.scale, self.bias, self.eps)


def make_norm(name, channels):
    if name == "none":
        return None
    if name == "group":
        return GroupNorm(num_groups(channels), channels)
    if name == "in":
        return GroupNorm(channels, channels, affine=False)
    raise ValueError(name)


class SpectralNormed(nn.Module):
    """flax's ``nn.SpectralNorm``: one power-iteration step from the stored
    ``u`` over the weight as an (out, -1) matrix on every call; ``train``
    stores the new ``u`` and sigma."""

    def _init_snorm(self, snorm, cout):
        self.snorm = snorm
        if snorm:
            self.register_buffer("u", torch.randn(1, cout))
            self.register_buffer("sigma", torch.ones(()))

    def weight_t(self):
        return self.weight.reshape(self.weight.shape[0], -1)

    def normed_weight(self, train):
        if not self.snorm:
            return self.weight
        wt = self.weight_t()
        l2n = lambda v: v / torch.sqrt((v * v).sum() + 1e-12)
        with torch.no_grad():
            v = l2n(self.u @ wt)
            u = l2n(v @ wt.t())
        sigma = ((v @ wt.t()) @ u.t())[0, 0]
        w = self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if train:
            self.u, self.sigma = u, sigma.detach()
        return w

    def init_rule(self, name, t):
        if name == "weight":
            return ("normal", self.fan_in() ** -0.5)
        return {"bias": ZERO, "u": ("normal", 1.0), "sigma": ONE}[name]


class Conv(SpectralNormed):
    """2D conv, NHWC, OIHW weight, symmetric padding."""

    def __init__(self, cin, cout, ks=3, stride=1, padding=0, bias=True, snorm=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, ks, ks))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self._init_snorm(snorm, cout)

    def fan_in(self):
        return int(np.prod(self.weight.shape[1:]))

    def forward(self, x, train=False):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.normed_weight(train), self.bias,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(SpectralNormed):
    """flax ``nn.ConvTranspose(ks, st, "SAME")``: torch's full transposed
    conv of the (in, out, kh, kw) weight, cut to lax's window of in * st."""

    def __init__(self, cin, cout, ks=3, stride=2, snorm=False):
        super().__init__()
        self.ks, self.stride = ks, stride
        self.weight = nn.Parameter(torch.empty(cin, cout, ks, ks))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._init_snorm(snorm, cout)

    def fan_in(self):
        w = self.weight
        return w.shape[0] * w.shape[2] * w.shape[3]

    def weight_t(self):
        return self.weight.transpose(0, 1).reshape(self.weight.shape[1], -1)

    def forward(self, x, train=False):
        h, wd, s, k = x.shape[1], x.shape[2], self.stride, self.ks
        if s > k:
            raise ValueError("stride above kernel size")
        pad_a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        a = k - 1 - pad_a
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.normed_weight(train),
                               self.bias, stride=s)
        return y[:, :, a:a + h * s, a:a + wd * s].permute(0, 2, 3, 1)


ACT = {"elu": F.elu, "relu": F.relu, "tanh": torch.tanh, "none": None}


class Conv2dBlock(nn.Module):
    def __init__(self, cin, out, ks=3, st=1, padding=0, norm="none", activation="elu",
                 use_bias=True, snorm=False):
        super().__init__()
        self.Conv_0 = Conv(cin, out, ks, st, padding, use_bias, snorm)
        self.GroupNorm_0 = make_norm(norm, out)
        self.act = ACT[activation]

    def forward(self, x, train=False):
        x = self.Conv_0(x, train)
        if self.GroupNorm_0 is not None:
            x = self.GroupNorm_0(x)
        return x if self.act is None else self.act(x)


class Conv2dTransposeBlock(nn.Module):
    def __init__(self, cin, out, ks=3, st=2, norm="none", activation="elu", snorm=False):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, out, ks, st, snorm)
        self.GroupNorm_0 = make_norm(norm, out)
        self.act = ACT[activation]

    def forward(self, x, train=False):
        x = self.ConvTranspose_0(x, train)
        if self.GroupNorm_0 is not None:
            x = self.GroupNorm_0(x)
        return x if self.act is None else self.act(x)


class ResBlock(nn.Module):
    def __init__(self, dim_in, dim_out, norm="group", upsampling=False, stride=1, snorm=False):
        super().__init__()
        self.upsampling = upsampling
        if upsampling:
            self.Conv2dTransposeBlock_0 = Conv2dTransposeBlock(dim_in, dim_out, 3, 2, norm, snorm=snorm)
            self.Conv2dBlock_0 = Conv2dBlock(dim_out, dim_out, 3, 1, 1, norm, "none", snorm=snorm)
            self.Conv2dTransposeBlock_1 = Conv2dTransposeBlock(dim_in, dim_out, 3, 2, "in", snorm=snorm)
        else:
            self.Conv2dBlock_0 = Conv2dBlock(dim_in, dim_out, 3, stride, 1, norm, snorm=snorm)
            self.Conv2dBlock_1 = Conv2dBlock(dim_out, dim_out, 3, 1, 1, norm, "none", snorm=snorm)
            if dim_in != dim_out or stride != 1:
                self.Conv2dBlock_2 = Conv2dBlock(dim_in, dim_out, 3, stride, 1, "in", snorm=snorm)

    def forward(self, x, train=False):
        if self.upsampling:
            h = self.Conv2dBlock_0(self.Conv2dTransposeBlock_0(x, train), train)
            return h + self.Conv2dTransposeBlock_1(x, train)
        h = self.Conv2dBlock_1(self.Conv2dBlock_0(x, train), train)
        return h + (self.Conv2dBlock_2(x, train) if hasattr(self, "Conv2dBlock_2") else x)


def resize_bilinear(y, height, width):
    """``jax.image.resize(..., "bilinear")``: half-pixel centres, with an
    antialiasing filter when downscaling."""
    out = F.interpolate(y.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class Spade(nn.Module):
    """GroupNorm without affine, modulated by (1 + gamma) and beta from convs
    over the start frame resized to the level; a clip's gamma and beta are
    shared by its frames (frames are clip-major)."""

    def __init__(self, num_features, cond_channels=3, hidden=128):
        super().__init__()
        self.num_features = num_features
        self.Conv_0 = Conv(cond_channels, hidden, 3, 1, 1)
        self.Conv_1 = Conv(hidden, num_features, 3, 1, 1)
        self.Conv_2 = Conv(hidden, num_features, 3, 1, 1)

    def modulation(self, y, height, width):
        y = F.leaky_relu(self.Conv_0(resize_bilinear(y, height, width)), 0.2)
        return self.Conv_1(y), self.Conv_2(y)

    def forward(self, x, mod):
        gamma, beta = mod
        n, h, w, c = x.shape
        t = n // gamma.shape[0]
        normed = group_norm(x.reshape(n, 1, h * w, c), num_groups(c)).reshape(gamma.shape[0], t, h, w, c)
        return (normed * (1.0 + gamma[:, None]) + beta[:, None]).reshape(n, h, w, c)


class ConvEncoder(nn.Module):
    """The frozen conditioner's and poke embedder's deterministic encoder."""

    def __init__(self, nf_in, nf_max, n_stages, snorm=False):
        super().__init__()
        nf = 32
        self.Conv2dBlock_0 = Conv2dBlock(nf_in, nf, 3, 2, 1, "group", snorm=snorm)
        for i in range(n_stages - 1):
            nf_next = min(nf * 2, nf_max)
            self.add_module(f"ResBlock_{i}", ResBlock(nf, nf_next, stride=2, snorm=snorm))
            nf = nf_next
        self.n_res = n_stages
        self.add_module(f"ResBlock_{n_stages - 1}", ResBlock(nf, nf_max, snorm=snorm))

    def forward(self, x):
        h = self.Conv2dBlock_0(x)
        for i in range(self.n_res):
            h = getattr(self, f"ResBlock_{i}")(h)
        return h


class FirstStageWrapper(nn.Module):
    def __init__(self, spatial, nf_in, nf_max, min_spatial=8):
        super().__init__()
        self.encoder = ConvEncoder(nf_in, nf_max, int(np.log2(spatial // min_spatial)))


class SpadeCondConvDecoder(nn.Module):
    def __init__(self, nf_in, dec_channels, out_channels=3, norm="group", snorm=False):
        super().__init__()
        self.ResBlock_0 = ResBlock(nf_in, dec_channels[0], norm=norm, snorm=snorm)
        self.n_up = len(dec_channels) - 1
        for i, (cin, nf) in enumerate(zip(dec_channels[:-1], dec_channels[1:])):
            self.add_module(f"ResBlock_{i + 1}", ResBlock(cin, nf, norm="none", upsampling=True, snorm=snorm))
            self.add_module(f"Spade_{i}", Spade(nf))
        self.Conv2dBlock_0 = Conv2dBlock(dec_channels[-1], out_channels, 3, 1, 1, "none",
                                         "tanh" if out_channels == 3 else "none")

    def spade_modulations(self, start_frame, in_size):
        mods, size = [], in_size
        for i in range(self.n_up):
            size *= 2
            mods.append(getattr(self, f"Spade_{i}").modulation(start_frame, size, size))
        return mods

    def forward(self, h_t, mods, train=False):
        h = self.ResBlock_0(h_t, train)
        for i in range(self.n_up):
            h = getattr(self, f"ResBlock_{i + 1}")(h, train)
            h = getattr(self, f"Spade_{i}")(h, mods[i])
        return self.Conv2dBlock_0(h)


class ConvGRUCell(nn.Module):
    def __init__(self, input_size, hidden_size, ks=3):
        super().__init__()
        cin = input_size + hidden_size
        self.update_gate = Conv(cin, hidden_size, ks, 1, ks // 2)
        self.reset_gate = Conv(cin, hidden_size, ks, 1, ks // 2)
        self.out_gate = Conv(cin, hidden_size, ks, 1, ks // 2)

    def forward(self, x, h):
        xh = torch.cat([x, h], dim=-1)
        update = torch.sigmoid(self.update_gate(xh))
        reset = torch.sigmoid(self.reset_gate(xh))
        out = torch.tanh(self.out_gate(torch.cat([x, h * reset], dim=-1)))
        return h * (1.0 - update) + out * update


class ConvGRU(nn.Module):
    def __init__(self, input_size, hidden_size, n_layers):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"cell_{i}", ConvGRUCell(input_size if i == 0 else hidden_size, hidden_size))

    def forward(self, x, hidden):
        new, inp = [], x
        for i in range(self.n_layers):
            inp = getattr(self, f"cell_{i}")(inp, hidden[i])
            new.append(inp)
        return tuple(new)


class FirstStageModel(nn.Module):
    """The first stage: with ``enc_channels`` its motion encoder, then the
    ConvGRU rollout from the motion bias and one SPADE decode per frame;
    ``spectral_norm`` in the decoder's ResBlock convs (training)."""

    def __init__(self, spatial, z_dim, dec_channels, n_gru_layers, min_spatial=8,
                 enc_channels=None, max_frames=10, spectral_norm=False):
        super().__init__()
        self.z_dim, self.n_gru_layers = z_dim, n_gru_layers
        if enc_channels is not None:
            from .motion import ResNetMotionEncoder

            self.enc_motion = ResNetMotionEncoder(enc_channels, z_dim, spatial, max_frames,
                                                  min_spatial)
        self.rnn = ConvGRU(z_dim, z_dim, n_gru_layers)
        self.motion_bias = nn.Parameter(torch.empty(1, min_spatial, min_spatial, z_dim))
        self.gen = SpadeCondConvDecoder(z_dim, dec_channels, 3, "group", snorm=spectral_norm)

    def init_rule(self, name, t):
        return ("normal", 1.0)

    def forward(self, X, noise, train=False):
        """(X_hat (B, T, H, W, 3), mu, logvar) of the clip X (B, T+1, H, W,
        3): the whole clip encoded, z = noise * exp(logvar / 2) + mu."""
        motion, mu, logvar = self.enc_motion(X, noise)
        return self.decode(motion, X[:, 0], X.shape[1] - 1, train), mu, logvar

    def decode(self, motion, start_frame, length, train=False):
        """(B, length, H, W, 3); eval decodes the B*length frames in one
        batch (clip-major), train frame by frame (each call advancing the
        spectral norms' u)."""
        hidden = tuple(motion for _ in range(self.n_gru_layers))
        in_rnn = self.motion_bias.expand(motion.shape[0], -1, -1, -1)
        mods = self.gen.spade_modulations(start_frame, motion.shape[1])
        hs = []
        for _ in range(length):
            hidden = self.rnn(in_rnn, hidden)
            hs.append(self.gen(hidden[-1], mods, train=True) if train else hidden[-1])
        if train:
            return torch.stack(hs, dim=1)
        frames = self.gen(torch.stack(hs, dim=1).flatten(0, 1), mods)
        return frames.reshape(motion.shape[0], length, *frames.shape[1:])
