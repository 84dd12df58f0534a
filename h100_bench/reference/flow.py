"""Plain PyTorch inverse of the multi-scale MaCow cINN, NHWC, over the
parameter tree of ``ipoke_tpu_torch/flows/macow.py`` (the same nesting and
leaf names, so one tree drives both).

Each inverse follows from the flow's forward definition and nothing else:
a masked-conv flow is inverted row by row (or column by column), each row
from the whole net evaluated on the rows already rebuilt, which is what
the autoregressive mask means; a NICE coupling recomputes its net on the
half it keeps.  No packing, no kernel, no tap sums: the port's K1, K2 and
K5 are checked against this.

``tree_specs`` gives how the benchmark draws the tree: fan-in scaled
normal conv kernels; weight-normed out convs with v ~ N(0, 0.05^2), their
gains g ~ N(0, shift^2) on the shift half of the outputs and N(0,
scale^2) on the log-scale half, biases b ~ N(0, scale^2), and ActNorms
with log-scale and bias ~ N(0, scale^2); random channel permutations.
(The port's ``entry.perturb`` draws every g and b at 0.01; at the SHIPPED
depth 0.03 on all of them overflows the inverse, as do shift gains of 0.2:
the inverse divides by a scale at every coupling, while a shift only
moves.)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F


def meta(*shape):
    return torch.empty(shape, device="meta")


def leaf_rule(path, shape, perturb):
    """How the benchmark draws the flow leaf at ``path`` (its keys)."""
    key = path[-1]
    if key in ("w_shift", "w1", "w2"):
        return ("normal", (shape[-4] * shape[-3] * shape[-2]) ** -0.5)
    if key == "v":
        return ("normal", 0.05)
    if key == "g":  # an out conv's outputs are [shift | log-scale]
        return ("normal", (perturb["shift"], perturb["scale"]))
    if key in ("b", "log_scale", "bias"):
        return ("normal", perturb["scale"])
    if key == "buf_perm":
        return ("perm",)
    if key == "buf_inv_perm":
        return ("inv_perm", ".".join(map(str, path[:-1] + ("buf_perm",))))
    raise KeyError(f"no rule for flow leaf {path}")


def tree_specs(tree, prefix, perturb):
    """(key, shape, rule) of every leaf of a (meta) tree; keys are the
    dotted paths ``ParamTree`` names them by."""
    out = []
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = prefix + (str(k),)
        if isinstance(v, (dict, list)):
            out += tree_specs(v, path, perturb)
        else:
            out.append((".".join(path), tuple(v.shape), leaf_rule(path, v.shape, perturb)))
    return out


def tree_fill(tree, values, prefix=()):
    """The nesting of ``tree`` with each leaf taken from ``values`` by its
    dotted path."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {k: tree_fill(v, values, prefix + (str(k),)) if isinstance(v, (dict, list))
           else values[".".join(prefix + (str(k),))] for k, v in items}
    return out if isinstance(tree, dict) else [out[i] for i in range(len(tree))]


def index(tree, i):
    if isinstance(tree, dict):
        return {k: index(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [index(v, i) for v in tree]
    return tree[i]


def stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [stack([t[i] for t in trees]) for i in range(len(first))]
    return meta(len(trees), *first.shape)


def conv(x, w, padding):
    """Stride-1 conv of NHWC ``x`` with an HWIO kernel; "SAME" pads as XLA
    (an even kernel's extra row and column after)."""
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        xc = F.pad(xc, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    return F.conv2d(xc, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def wn_weight(p):
    v = p["v"]
    return v * (p["g"] / torch.sqrt((v * v).sum(dim=(0, 1, 2)) + 1e-12))


def affine_inverse(y, raw):
    """x of y = scale * x + mu, scale = 1 + tanh(log_scale / 2)."""
    mu, log_scale = torch.chunk(raw, 2, dim=-1)
    return (y - mu) / (torch.tanh(log_scale * 0.5) + 1.0 + 1e-12)


@dataclasses.dataclass(frozen=True)
class ActNorm:
    channels: int

    def init(self):
        return {"log_scale": meta(self.channels), "bias": meta(self.channels)}

    def inverse(self, p, y, h=None):
        return (y - p["bias"]) / (torch.exp(p["log_scale"]) + 1e-8)


@dataclasses.dataclass(frozen=True)
class Shuffle:
    channels: int

    def init(self):
        return {"buf_perm": meta(self.channels), "buf_inv_perm": meta(self.channels)}

    def inverse(self, p, y, h=None):
        return torch.index_select(y, -1, p["buf_inv_perm"])


@dataclasses.dataclass(frozen=True)
class MaskedConv:
    """y = scale(x) * x + mu(x), where (mu, log_scale) at a pixel come from a
    conv that sees only the rows strictly above it (order A), below (B),
    the columns strictly left (C) or right (D), concatenated with h, ELU,
    and a weight-normed 1x1 conv.  C/D store their kernel (kw, kh)."""

    channels: int
    kernel: Tuple[int, int]
    order: str
    hidden: int
    h_channels: int

    def init(self):
        kh, kw = self.kernel
        return {"w_shift": meta(kh, kw, self.channels, self.hidden),
                "out": {"v": meta(1, 1, self.hidden + self.h_channels, 2 * self.channels),
                        "g": meta(2 * self.channels), "b": meta(2 * self.channels)}}

    def shifted(self, w, x):
        kh, kw = w.shape[0], w.shape[1]
        if self.order in ("A", "B"):
            cw = (kw - 1) // 2
            xp = F.pad(x, (0, 0, cw, cw, kh, 0))[:, :-1] if self.order == "A" \
                else F.pad(x, (0, 0, cw, cw, 0, kh))[:, 1:]
        else:
            ch = (kh - 1) // 2
            xp = F.pad(x, (0, 0, kw, 0, ch, ch))[:, :, :-1] if self.order == "C" \
                else F.pad(x, (0, 0, 0, kw, ch, ch))[:, :, 1:]
        return conv(xp, w, "VALID")

    def inverse(self, p, y, h):
        w_out, b_out = wn_weight(p["out"]), p["out"]["b"]
        x = torch.zeros_like(y)
        axis = 1 if self.order in ("A", "B") else 2
        n = y.shape[axis]
        for i in (range(n) if self.order in ("A", "C") else reversed(range(n))):
            hid = F.elu(torch.cat([self.shifted(p["w_shift"], x), h], dim=-1))
            raw = conv(hid, w_out, "VALID") + b_out
            sel = (slice(None), i) if axis == 1 else (slice(None), slice(None), i)
            x[sel] = affine_inverse(y[sel], raw[sel])
        return x


@dataclasses.dataclass(frozen=True)
class NICE:
    """Affine coupling over a channel split ("continuous": the first
    channels, "skip": every other one); the net on the kept half z: 3x3
    conv, ELU, 1x1 conv, ELU, weight-normed 3x3 conv."""

    channels: int
    hidden: int
    split: str = "continuous"
    order: str = "up"
    factor: int = 2

    @property
    def out_channels(self):
        return self.channels // self.factor

    @property
    def z1_channels(self):
        return self.channels - self.out_channels if self.order == "up" else self.out_channels

    def init(self):
        in1 = self.channels - self.out_channels
        return {"w1": meta(3, 3, in1, self.hidden), "w2": meta(1, 1, self.hidden, self.hidden),
                "out": {"v": meta(3, 3, self.hidden, 2 * self.out_channels),
                        "g": meta(2 * self.out_channels), "b": meta(2 * self.out_channels)}}

    def inverse(self, p, y, h=None):
        if self.split == "continuous":
            z1, z2 = y[..., :self.z1_channels], y[..., self.z1_channels:]
        else:
            z1, z2 = y[..., 0::2], y[..., 1::2]
        z, zp = (z1, z2) if self.order == "up" else (z2, z1)
        a = F.elu(conv(z, p["w1"], "SAME"))
        a = F.elu(conv(a, p["w2"], "VALID"))
        zp = affine_inverse(zp, conv(a, wn_weight(p["out"]), "SAME") + p["out"]["b"])
        z1, z2 = (z, zp) if self.order == "up" else (zp, z)
        if self.split == "continuous":
            return torch.cat([z1, z2], dim=-1)
        return torch.stack([z1, z2], dim=-1).reshape(*z1.shape[:-1], -1)


@dataclasses.dataclass(frozen=True)
class Chain:
    flows: tuple

    def init(self):
        return [f.init() for f in self.flows]

    def inverse(self, p, y, h=None):
        for f, q in zip(reversed(self.flows), reversed(p)):
            y = f.inverse(q, y, h)
        return y


def macow_unit(c, kernel, h_channels):
    kh, kw = kernel
    mk = lambda order, ks: MaskedConv(c, ks, order, 4 * c if c <= 96 else min(2 * c, 512), h_channels)
    return Chain((mk("A", (kh, kw)), mk("B", (kh, kw)), ActNorm(c),
                  mk("C", (kw, kh)), mk("D", (kw, kh)), ActNorm(c)))


def macow_step(c, kernel, hidden, h_channels):
    unit = lambda: macow_unit(c, kernel, h_channels)
    return Chain((ActNorm(c), Shuffle(c), unit(), unit(),
                  NICE(c, hidden, "continuous", "up"), NICE(c, hidden, "continuous", "down"),
                  ActNorm(c), unit(), unit(),
                  NICE(c, hidden, "skip", "up"), NICE(c, hidden, "skip", "down")))


@dataclasses.dataclass(frozen=True)
class MultiScaleInternal:
    """Per level: ``num_steps[i]`` steps, a prior (shuffle, NICE with the
    level's factor, ActNorm on the factored-out part), a shuffle, then the
    last channels factored out; z packs [final, split_{L-1}, ..., split_0]."""

    num_steps: Tuple[int, ...]
    in_channels: int
    hidden: int
    h_channels: int
    factor: int = 16
    kernel: Tuple[int, int] = (2, 3)

    def levels(self):
        out, c, factor = [], self.in_channels, self.factor
        for n in self.num_steps:
            prior = NICE(c, self.hidden, "continuous", "up", factor)
            out.append((macow_step(c, self.kernel, self.hidden, self.h_channels), n,
                        prior, ActNorm(c // factor), Shuffle(c)))
            c -= self.in_channels // self.factor
            factor -= 1
        return out

    def init(self):
        return [{"steps": stack([step.init() for _ in range(n)]),
                 "prior": {"perm": Shuffle(prior.channels).init(), "coupling": prior.init(),
                           "actnorm": an.init()},
                 "perm": perm.init()}
                for step, n, prior, an, perm in self.levels()]

    def inverse(self, params, y, h):
        levels = self.levels()
        out, splits = y, []
        for _, _, prior, _, _ in levels:
            splits.append(out[..., prior.z1_channels:])
            out = out[..., :prior.z1_channels]
        for (step, n, prior, an, perm), p, z2 in zip(reversed(levels), reversed(params),
                                                      reversed(splits)):
            out = perm.inverse(p["perm"], torch.cat([out, z2], dim=-1))
            z1c = prior.z1_channels
            out = torch.cat([out[..., :z1c], an.inverse(p["prior"]["actnorm"], out[..., z1c:])], dim=-1)
            out = prior.inverse(p["prior"]["coupling"], out)
            out = Shuffle(prior.channels).inverse(p["prior"]["perm"], out)
            for i in reversed(range(n)):
                out = step.inverse(index(p["steps"], i), out, h)
        return out
