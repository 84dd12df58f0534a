"""Elementwise transforms, small invertible layers and the convolutions of
the coupling nets (counterpart of ``ipoke_tpu/flows/primitives.py``).  All
arrays NHWC, kernels HWIO."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .base import Flow, randn


def _sum_logdet(t):
    """Per-sample sum in fp32: under bf16 a sum over H*W*C log-scales would
    round away ~3 decimal digits."""
    return t.reshape(t.shape[0], -1).float().sum(dim=1)


class Additive:
    """``y = z + mu``; logdet 0."""

    n_params = 1

    @staticmethod
    def calc(raw):
        return (raw,)

    @staticmethod
    def fwd(z, params):
        (mu,) = params
        return z + mu, z.new_zeros(z.shape[0], dtype=torch.float32)

    @staticmethod
    def bwd(z, params):
        (mu,) = params
        return z - mu


class Affine:
    """``y = scale*z + mu`` with ``scale = 1 + alpha*tanh(log_scale/2)``."""

    n_params = 2

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def calc(self, raw):
        mu, log_scale = torch.chunk(raw, 2, dim=-1)
        scale = torch.tanh(log_scale * 0.5) * self.alpha + 1.0
        return mu, scale

    @staticmethod
    def fwd(z, params):
        mu, scale = params
        return scale * z + mu, _sum_logdet(torch.log(scale))

    @staticmethod
    def bwd(z, params):
        mu, scale = params
        return (z - mu) / (scale + 1e-12)


class ReLUTransform:
    """Piecewise scaling of the positive pre-images: ``y = s*z + mu`` with
    ``s = 1 + tanh(log_scale)`` where z > 0, else 1."""

    n_params = 2

    @staticmethod
    def calc(raw):
        mu, log_scale = torch.chunk(raw, 2, dim=-1)
        return mu, torch.tanh(log_scale)

    @staticmethod
    def fwd(z, params):
        mu, scale = params
        s = scale * (z > 0.0).to(z.dtype) + 1.0
        return s * z + mu, _sum_logdet(torch.log(s))

    @staticmethod
    def bwd(z, params):
        mu, scale = params
        z = z - mu
        s = scale * (z > 0.0).to(z.dtype) + 1.0
        return z / (s + 1e-12)


def get_transform(name: str, alpha: float = 1.0):
    if name == "additive":
        return Additive()
    if name == "affine":
        return Affine(alpha)
    if name == "relu":
        return ReLUTransform()
    raise ValueError(f"unknown transform {name!r}")


@dataclasses.dataclass(frozen=True)
class ActNorm(Flow):
    channels: int

    def init(self, generator, device):
        return {"log_scale": randn((self.channels,), generator, device, 0.05),
                "bias": torch.zeros((self.channels,), device=device)}

    def forward(self, params, x, h=None):
        y = x * torch.exp(params["log_scale"]) + params["bias"]
        hw = x.shape[1] * x.shape[2] if x.ndim == 4 else 1
        ld = (params["log_scale"].float().sum() * hw).expand(x.shape[0])
        return y, ld

    def inverse(self, params, y, h=None):
        return (y - params["bias"]) / (torch.exp(params["log_scale"]) + 1e-8)

    def ddi(self, params, x, h=None):
        """Glow-style init from the *input* statistics (ddof 1), so that the
        output is exactly normalised, as the JAX package does."""
        flat = x.reshape(-1, x.shape[-1])
        inv = 1.0 / (flat.std(dim=0) + 1e-6)
        new = {"log_scale": torch.log(inv), "bias": -flat.mean(dim=0) * inv}
        y, ld = self.forward(new, x)
        return y, ld, new


@dataclasses.dataclass(frozen=True)
class Shuffle(Flow):
    """Fixed channel permutation; the int32 perms are buffers."""

    channels: int

    def init(self, generator, device):
        if torch.device(device).type == "meta":
            perm = torch.empty((self.channels,), dtype=torch.int32, device="meta")
            return {"buf_perm": perm, "buf_inv_perm": torch.empty_like(perm)}
        perm = torch.randperm(self.channels, generator=generator, device=device)
        return {"buf_perm": perm.to(torch.int32),
                "buf_inv_perm": torch.argsort(perm).to(torch.int32)}

    def forward(self, params, x, h=None):
        return (torch.index_select(x, -1, params["buf_perm"]),
                x.new_zeros(x.shape[0], dtype=torch.float32))

    def inverse(self, params, y, h=None):
        return torch.index_select(y, -1, params["buf_inv_perm"])


@dataclasses.dataclass(frozen=True)
class InvConvLU(Flow):
    """Invertible 1x1 conv, LU-parameterised: W = P (L + I) (U + diag(sign_s
    * exp(log_s))), with L strictly lower and U strictly upper triangular;
    the permutation ``buf_p`` and the signs ``buf_sign_s`` are buffers.  The
    init is the LU factorisation of the Q of a QR of a normal draw, in
    float64 on the CPU.  W is formed in fp32 whatever the params' dtype, as
    the JAX package's fp32 masks promote it, so that its inverse exists
    under bf16 params too; the outputs come back in the input's dtype."""

    channels: int

    def init(self, generator, device):
        c = self.channels
        if torch.device(device).type == "meta":
            e = lambda: torch.empty((c, c), device="meta")
            return {"buf_p": e(), "buf_sign_s": torch.empty((c,), device="meta"),
                    "l": e(), "u": e(), "log_s": torch.empty((c,), device="meta")}
        w = torch.randn((c, c), generator=generator, device=device)
        q, _ = torch.linalg.qr(w.cpu().double())
        p, lower, upper = torch.linalg.lu(q)
        s = torch.diagonal(upper)
        f32 = lambda t: t.to(device=device, dtype=torch.float32)
        return {"buf_p": f32(p), "buf_sign_s": f32(torch.sign(s)), "l": f32(lower),
                "u": f32(torch.triu(upper, 1)), "log_s": f32(torch.log(s.abs()))}

    def weight(self, params):
        """W (out, in) in fp32."""
        f32 = lambda k: params[k].float()
        c = self.channels
        lmask = torch.tril(torch.ones((c, c), device=params["l"].device), -1)
        wl = f32("l") * lmask + torch.eye(c, device=lmask.device)
        wu = f32("u") * lmask.t() + torch.diag(f32("buf_sign_s") * torch.exp(f32("log_s")))
        return f32("buf_p") @ wl @ wu

    def forward(self, params, x, h=None):
        y = torch.matmul(x.float(), self.weight(params).t()).to(x.dtype)
        hw = x.shape[1] * x.shape[2] if x.ndim == 4 else 1
        ld = (params["log_s"].float().sum() * hw).expand(x.shape[0])
        return y, ld

    def inverse(self, params, y, h=None):
        w_inv = torch.linalg.inv(self.weight(params))
        return torch.matmul(y.float(), w_inv.t()).to(y.dtype)


@dataclasses.dataclass(frozen=True)
class SpaceToDepth(Flow):
    """(B, H, W, C) <-> (B, H/2, W/2, 4C), channels in (dy, dx, c) order;
    volume-preserving, logdet 0.  ``inverse_direction``: depth-to-space
    forward."""

    inverse_direction: bool = False

    def init(self, generator, device):
        return {}

    @staticmethod
    def down(x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)

    @staticmethod
    def up(x):
        b, h, w, c = x.shape
        x = x.reshape(b, h, w, 2, 2, c // 4)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * 2, w * 2, c // 4)

    def forward(self, params, x, h=None):
        y = self.up(x) if self.inverse_direction else self.down(x)
        return y, x.new_zeros(x.shape[0], dtype=torch.float32)

    def inverse(self, params, y, h=None):
        return self.down(y) if self.inverse_direction else self.up(y)


# ---------------------------------------------------------------------------
# convolutions on NHWC tensors with HWIO kernels (the JAX layouts)
# ---------------------------------------------------------------------------

def conv_init(generator, device, kh, kw, cin, cout):
    return randn((kh, kw, cin, cout), generator, device, (kh * kw * cin) ** -0.5)


def wn_conv_init(generator, device, kh, kw, cin, cout, zero_init=False):
    v = randn((kh, kw, cin, cout), generator, device, 0.05)
    g = torch.zeros((cout,), device=device) if zero_init else _v_norm(v)
    return {"v": v, "g": g, "b": torch.zeros((cout,), device=device)}


def _v_norm(v):
    return torch.sqrt(torch.sum(v * v, dim=(0, 1, 2)) + 1e-12)


def plain_conv_apply(w, x, padding="VALID"):
    """Stride-1 conv of NHWC ``x`` with HWIO ``w``; ``"SAME"`` pads like
    XLA (the extra row/column of an even kernel goes after)."""
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        xc = F.pad(xc, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    elif padding != "VALID":
        raise ValueError(padding)
    return F.conv2d(xc, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def wn_conv_apply(params, x, padding="SAME"):
    """Weight-norm conv: ``v * g / ||v||`` (norm over all but the output
    axis), then bias."""
    w = params["v"] * (params["g"] / _v_norm(params["v"]))
    return plain_conv_apply(w, x, padding) + params["b"]


def wn_conv_ddi(params, x, padding="SAME", init_scale=1.0):
    """Data-dependent re-init of (g, b) so that the outputs have zero mean and
    ``init_scale`` times unit std (ddof 1) over the batch."""
    flat = wn_conv_apply(params, x, padding).reshape(-1, params["v"].shape[-1])
    inv = init_scale / (flat.std(dim=0) + 1e-6)
    return dict(params, g=params["g"] * inv, b=-flat.mean(dim=0) * inv)


def shifted_conv_apply(w, x, order: str):
    """Masked ("causal") conv without bias: order A sees the rows strictly
    above, B strictly below, C the columns strictly left, D strictly right.
    ``w`` is (kh, kw, Cin, Cout) as stored (C/D store the dims swapped)."""
    kh, kw = w.shape[0], w.shape[1]
    if order in ("A", "B"):
        cw = (kw - 1) // 2
        if order == "A":
            xp = F.pad(x, (0, 0, cw, cw, kh, 0))[:, :-1]
        else:
            xp = F.pad(x, (0, 0, cw, cw, 0, kh))[:, 1:]
    elif order in ("C", "D"):
        ch = (kh - 1) // 2
        if order == "C":
            xp = F.pad(x, (0, 0, kw, 0, ch, ch))[:, :, :-1]
        else:
            xp = F.pad(x, (0, 0, 0, kw, ch, ch))[:, :, 1:]
    else:
        raise ValueError(order)
    return plain_conv_apply(w, xp)


def conv1x1_dot(w, x):
    """1x1 conv as one (M, Cin) @ (Cin, N) product, fp32 accumulation, cast
    back to the input dtype."""
    b, hh, ww, cin = x.shape
    o = torch.matmul(x.reshape(-1, cin).float(), w[0, 0].float())
    return o.reshape(b, hh, ww, -1).to(x.dtype)


def shifted_tap_sum(u, kh, kw):
    """Epilogue of the tap-packed conv: ``u`` (B, H, W, kh, kw, N) holds each
    tap's output at the pixel it reads; the tap that sees input pixel
    (y+dy-ph, x+dx-pw) contributes to output pixel (y, x)."""
    bsz, hh, ww = u.shape[:3]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    up = F.pad(u, (0, 0, 0, 0, 0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            s = up[:, dy:dy + hh, dx:dx + ww, dy, dx, :]
            acc = s if acc is None else acc + s
    return acc


def wn_conv_apply_packed(params, x):
    """3x3 SAME weight-norm conv as one (M, Cin) @ (Cin, 9*N) product plus
    nine shifted adds; fp32 accumulation, cast back to the input dtype."""
    v, g, b = params["v"], params["g"], params["b"]
    kh, kw, cin, n = v.shape
    w = (v * (g / _v_norm(v))).to(x.dtype)
    bsz, hh, ww, _ = x.shape
    wp = w.permute(2, 0, 1, 3).reshape(cin, kh * kw * n)
    u = torch.matmul(x.reshape(-1, cin).float(), wp.float())
    acc = shifted_tap_sum(u.reshape(bsz, hh, ww, kh, kw, n), kh, kw)
    return acc.to(x.dtype) + b
