"""The reference's other INN blocks (counterpart of
``ipoke_tpu/flows/extra.py``; no config builds them):

* ``MixCDFCoupling``: a coupling whose elementwise transform is a logistic
  mixture CDF composed with an inverse sigmoid (Flow++-style); the forward
  is closed-form, the inverse a 50-step bisection of the monotone CDF, as
  in the JAX package.  ``make_mixcdf_block`` / ``build_mixcdf_flow`` stack
  it; ``HierarchicalCouplingFlow`` stacks [Shuffle, ActNorm, n x NICE]
  levels with channel factoring.
* ``MADE``: the masked autoregressive MLP, its masks (``made_masks``) drawn
  with numpy from the JAX package's seed, so both packages hold the same
  masks bit for bit.
* ``concat_elu``, ``GatedConv2d`` and ``GatedAttention``: the building
  blocks of the reference's attention flows, NHWC.

Parameter trees repeat the JAX package's keys and layouts (HWIO conv
kernels, (in, out) dense weights), so ``convert.flow_params`` carries them
across."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .base import Chain, Flow, randn
from .macow import NICE2d
from .primitives import (
    ActNorm,
    Shuffle,
    conv_init,
    plain_conv_apply,
    wn_conv_apply,
    wn_conv_init,
)


def mixlogcdf(x, logits, means, log_scales):
    """CDF of a K-logistic mixture, elementwise: ``x`` (...) against params
    (..., K)."""
    w = torch.softmax(logits, dim=-1)
    z = (x[..., None] - means) * torch.exp(-log_scales)
    return torch.sum(w * torch.sigmoid(z), dim=-1)


def mixlogpdf_log(x, logits, means, log_scales):
    """Log-density of the mixture at ``x``."""
    logw = torch.log_softmax(logits, dim=-1)
    z = (x[..., None] - means) * torch.exp(-log_scales)
    log_pdf = z - log_scales - 2.0 * F.softplus(z)
    return torch.logsumexp(logw + log_pdf, dim=-1)


def _inv_mixlogcdf(y, logits, means, log_scales, iters: int = 50):
    """Bisection inverse of the monotone mixture CDF, ``iters`` halvings of
    [min(mean - 20 scale), max(mean + 20 scale)]."""
    lo = torch.amin(means - 20.0 * torch.exp(log_scales), dim=-1)
    hi = torch.amax(means + 20.0 * torch.exp(log_scales), dim=-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = mixlogcdf(mid, logits, means, log_scales) < y
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


@dataclasses.dataclass(frozen=True)
class MixCDFCoupling(Flow):
    """Channel-split coupling x2' = logit(MixLogCDF(x2; net(x1))) * exp(a)
    + b; the net is a 3x3 conv, ELU and a weight-norm 3x3 conv emitting 3K
    + 2 values per transformed channel (K logits, means, log-scales clipped
    to [-7, 7], then a = tanh(.) and b)."""

    in_channels: int
    hidden_channels: int = 64
    components: int = 4

    @property
    def _c1(self):
        return self.in_channels // 2 + self.in_channels % 2

    @property
    def _c2(self):
        return self.in_channels // 2

    def init(self, generator, device):
        out_c = self._c2 * (3 * self.components + 2)
        return {
            "w1": conv_init(generator, device, 3, 3, self._c1, self.hidden_channels),
            "out": wn_conv_init(generator, device, 3, 3, self.hidden_channels,
                                out_c, zero_init=True),
        }

    def _params(self, params, x1):
        h = F.elu(plain_conv_apply(params["w1"], x1, padding="SAME"))
        raw = wn_conv_apply(params["out"], h, "SAME")
        k = self.components
        raw = raw.reshape(*raw.shape[:-1], self._c2, 3 * k + 2)
        logits, means = raw[..., :k], raw[..., k:2 * k]
        log_scales = torch.clamp(raw[..., 2 * k:3 * k], -7.0, 7.0)
        return logits, means, log_scales, torch.tanh(raw[..., 3 * k]), raw[..., 3 * k + 1]

    def forward(self, params, x, h=None):
        x1, x2 = x[..., :self._c1], x[..., self._c1:]
        logits, means, log_scales, a, b = self._params(params, x1)
        eps = 1e-5
        cdf = torch.clamp(mixlogcdf(x2, logits, means, log_scales), eps, 1 - eps)
        y2 = (torch.log(cdf) - torch.log1p(-cdf)) * torch.exp(a) + b
        # logdet: log pdf + log d(logit)/d(cdf) + a
        ld_el = (mixlogpdf_log(x2, logits, means, log_scales)
                 - torch.log(cdf) - torch.log1p(-cdf) + a)
        return torch.cat([x1, y2], dim=-1), ld_el.reshape(x.shape[0], -1).sum(dim=1)

    def inverse(self, params, y, h=None):
        x1, y2 = y[..., :self._c1], y[..., self._c1:]
        logits, means, log_scales, a, b = self._params(params, x1)
        cdf = torch.sigmoid((y2 - b) * torch.exp(-a))
        return torch.cat([x1, _inv_mixlogcdf(cdf, logits, means, log_scales)], dim=-1)


def make_mixcdf_block(in_channels, hidden_channels=64, components=4) -> Chain:
    return Chain((ActNorm(in_channels), Shuffle(in_channels),
                  MixCDFCoupling(in_channels, hidden_channels, components)))


def build_mixcdf_flow(in_channels, n_blocks=4, hidden_channels=64,
                      components=4) -> Chain:
    """The reference's ``UnsupervisedHierarchicalMixCDFTransformer`` core,
    as the JAX package builds it: a uniform stack of blocks."""
    return Chain(tuple(make_mixcdf_block(in_channels, hidden_channels, components)
                       for _ in range(n_blocks)))


@dataclasses.dataclass(frozen=True)
class HierarchicalCouplingFlow(Flow):
    """[Shuffle -> ActNorm -> n x NICE(cond)] levels, factoring out
    ``in_channels // factor`` channels after each (reference
    ``HierarchicalConvCouplingFlow``)."""

    num_steps: Tuple[int, ...]
    in_channels: int
    hidden_channels: int
    h_channels: int = 0
    factor: int = 4
    n_blocks: int = 2

    def _levels(self):
        levels = []
        c = self.in_channels
        step = self.in_channels // self.factor
        for n in self.num_steps:
            parts = [Shuffle(c), ActNorm(c)] + [
                NICE2d(c, hidden_channels=self.hidden_channels,
                       h_channels=self.h_channels, split_type="continuous", order="up")
                for _ in range(n * self.n_blocks)]
            levels.append((Chain(tuple(parts)), c - step))
            c -= step
        return levels

    def init(self, generator, device):
        return [chain.init(generator, device) for chain, _ in self._levels()]

    def forward(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        out, splits = x, []
        for (chain, keep), p in zip(self._levels(), params):
            out, l = chain.forward(p, out, h)
            ld = ld + l
            splits.append(out[..., keep:])
            out = out[..., :keep]
        splits.append(out)
        return torch.cat(splits[::-1], dim=-1), ld

    def inverse(self, params, y, h=None):
        levels = self._levels()
        out, splits = y, []
        for _, keep in levels:
            splits.append(out[..., keep:])
            out = out[..., :keep]
        for (chain, _), p, z2 in zip(reversed(levels), reversed(params),
                                     reversed(splits)):
            out = chain.inverse(p, torch.cat([out, z2], dim=-1), h)
        return out


# ---------------------------------------------------------------------------
# MADE (reference ARFullyConnectedNet)
# ---------------------------------------------------------------------------

def made_masks(nin: int, hidden_sizes, nout: int, seed: int = 0,
               natural_ordering: bool = True):
    """Connectivity masks per layer (Germain et al. 2015, the reference's
    ``update_masks``): numpy's ``RandomState(seed)`` draws the hidden
    units' degrees, so the masks are the JAX package's bit for bit.
    float32 tensors, (in, out) per layer."""
    rng = np.random.RandomState(seed)
    m = {-1: np.arange(nin) if natural_ordering else rng.permutation(nin)}
    for layer, h in enumerate(hidden_sizes):
        m[layer] = rng.randint(m[layer - 1].min(), nin - 1, size=h)
    n = len(hidden_sizes)
    masks = [m[layer - 1][:, None] <= m[layer][None, :] for layer in range(n)]
    masks.append(m[n - 1][:, None] < m[-1][None, :])
    if nout > nin:
        masks[-1] = np.concatenate([masks[-1]] * (nout // nin), axis=1)
    return [torch.as_tensor(mk.astype(np.float32)) for mk in masks]


@dataclasses.dataclass(frozen=True)
class MADE:
    """Autoregressive MLP: output chunk j depends only on inputs before j
    (under the ordering); an optional conditioning net is added layer by
    layer (the reference's ``condnet``)."""

    nin: int
    hidden_sizes: Tuple[int, ...]
    nout: int
    ncond: int = 0
    natural_ordering: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.nout % self.nin:
            raise ValueError(f"MADE: nout {self.nout} is not a multiple of nin {self.nin}")

    def _masks(self, device):
        return [mk.to(device) for mk in made_masks(
            self.nin, list(self.hidden_sizes), self.nout, self.seed,
            self.natural_ordering)]

    def init(self, generator, device):
        def layers(dims):
            return [{"w": randn((d0, d1), generator, device, d0 ** -0.5),
                     "b": torch.zeros((d1,), device=device)}
                    for d0, d1 in zip(dims, dims[1:])]

        params = {"net": layers([self.nin, *self.hidden_sizes, self.nout])}
        if self.ncond > 0:
            params["cond"] = layers([self.ncond, *self.hidden_sizes, self.nout])
        return params

    def apply(self, params, x, y=None):
        h, hc = x, y
        for i, (lyr, mk) in enumerate(zip(params["net"], self._masks(x.device))):
            if i > 0:
                h = F.relu(h)
                if hc is not None:
                    hc = F.relu(hc)
            out = h @ (lyr["w"] * mk) + lyr["b"]
            if self.ncond > 0:
                c = params["cond"][i]
                hc = hc @ c["w"] + c["b"]
                out = out + hc
            h = out
        return h


# ---------------------------------------------------------------------------
# Gated conv / gated attention (reference GatedConv2d / GatedAttentionLayer)
# ---------------------------------------------------------------------------

def concat_elu(x):
    """ConcatELU (doubles the channels)."""
    return torch.cat([F.elu(x), F.elu(-x)], dim=-1)


def _gate(x):
    a, b = torch.chunk(x, 2, dim=-1)
    return a * torch.sigmoid(b)


def _conv(p, x):
    return plain_conv_apply(p["w"], x, padding="SAME") + p["b"]


@dataclasses.dataclass(frozen=True)
class GatedConv2d:
    """x + gate(conv(concat_elu(conv(concat_elu(x)) [+ cond])))."""

    dim: int
    dim_cond: int = 0
    dim_out: int = 0  # 0: as dim

    @property
    def _out(self):
        return self.dim_out or self.dim

    def init(self, generator, device):
        def cv(kh, kw, cin, cout):
            return {"w": conv_init(generator, device, kh, kw, cin, cout),
                    "b": torch.zeros((cout,), device=device)}

        p = {"conv1": cv(3, 3, 2 * self.dim, self.dim),
             "conv2": cv(3, 3, 2 * self.dim, 2 * self._out)}
        if self.dim_cond:
            p["cond_conv"] = cv(3, 3, 2 * self.dim_cond, self.dim)
        if self.dim_out:
            p["conv_sc"] = cv(1, 1, self.dim, self._out)
        return p

    def apply(self, params, x, xc=None):
        c1 = _conv(params["conv1"], concat_elu(x))
        sc = _conv(params["conv_sc"], x) if self.dim_out else x
        if self.dim_cond:
            c1 = c1 + _conv(params["cond_conv"], concat_elu(xc))
        return sc + _gate(_conv(params["conv2"], concat_elu(c1)))


@dataclasses.dataclass(frozen=True)
class GatedAttention:
    """x + gate(proj2(MHSA(x + pos_emb))) over the H*W token grid."""

    channels: int
    heads: int

    def __post_init__(self):
        if self.channels % self.heads:
            raise ValueError(f"GatedAttention: {self.channels} channels over "
                             f"{self.heads} heads")

    def init(self, generator, device, spatial: Tuple[int, int]):
        c = self.channels
        return {
            "proj1": {"w": randn((c, 3 * c), generator, device, c ** -0.5),
                      "b": torch.zeros((3 * c,), device=device)},
            "proj2": {"w": randn((c, 2 * c), generator, device, c ** -0.5),
                      "b": torch.zeros((2 * c,), device=device)},
            "pos_emb": randn((*spatial, c), generator, device, 0.02),
        }

    def apply(self, params, x):
        b, hh, ww, c = x.shape
        d, t = c // self.heads, hh * ww
        h = (x + params["pos_emb"]).reshape(b, t, c)
        qkv = h @ params["proj1"]["w"] + params["proj1"]["b"]
        q, k, v = qkv.reshape(b, t, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        w = torch.softmax(q @ k.transpose(-1, -2) / float(d) ** 0.5, dim=-1)
        a = (w @ v).permute(0, 2, 1, 3).reshape(b, t, c)
        out = a @ params["proj2"]["w"] + params["proj2"]["b"]
        return x + _gate(out.reshape(b, hh, ww, 2 * c))
