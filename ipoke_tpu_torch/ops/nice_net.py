"""K1: the fused NICE coupling net, inference (replaces
``ipoke_tpu/ops/nice_net.py::nice_net_raw_pallas``).

Every NICE coupling of the cINN evaluates w1 (3x3 conv) -> ELU -> w2 (1x1,
hidden x hidden) -> ELU -> out (3x3 weight-norm conv, skinny).  The kernel
(``csrc/nice_net.cu``) computes the three contractions of that chain,

    u = elu(elu(zcol @ w1) @ w2) @ wp        (bf16 operands, fp32 sums)

with ``zcol`` the 3x3 im2col of the coupling input and ``wp`` the tap-packed
out weight; the hidden activations never reach device memory.  The im2col,
the shifted-add epilogue of the tap-packed conv, the bias and the
h-conditioning half of the out conv run here in torch, as the JAX package
runs them outside its kernel.  ``nice_net_plain`` is the same chain in
plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build
from ..flows.primitives import _v_norm, plain_conv_apply, shifted_tap_sum


def nice_net_fits(params, z, h) -> bool:
    """The JAX package's static shape family for the kernel
    (``nice_net_fits``) without its TPU VMEM budget: 3x3 in and out convs,
    a 1x1 w2, a hidden width that is a multiple of 128, at most 512 pixels
    per image, and ``h`` given when the out conv has conditioning rows."""
    w1, v = params["w1"], params["out"]["v"]
    kh, kw, _, hid = w1.shape
    if (kh, kw) != (3, 3) or tuple(v.shape[:2]) != (3, 3) \
            or tuple(params["w2"].shape[:2]) != (1, 1):
        return False
    if hid % 128 != 0 or z.shape[1] * z.shape[2] > 512:
        return False
    return not (v.shape[2] > hid and h is None)


def _elu_f32(a):
    return torch.where(a > 0, a, torch.expm1(torch.clamp(a, max=0.0)))


def nice_net_plain(zcol, w1, w2, wp):
    """Plain version of the kernel: every product in fp32 over the bf16
    operands, ELU on the fp32 sums, rounded to the operand dtype before the
    next product, as the TPU kernel does."""
    dt = zcol.dtype
    a = _elu_f32(torch.matmul(zcol.float(), w1.float())).to(dt)
    b = _elu_f32(torch.matmul(a.float(), w2.float())).to(dt)
    return torch.matmul(b.float(), wp.float())


def _pad_cols(t, n):
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def nice_net_cuda(zcol, w1, w2, wp):
    """Launch the kernel: ``zcol`` (M, K1), ``w1`` (K1, Hid), ``w2``
    (Hid, Hid), ``wp`` (Hid, N), all bf16 on one CUDA device; returns u
    (M, N) fp32.  K1 and N are zero-padded to multiples of 16 here."""
    tensors = (zcol, w1, w2, wp)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("nice_net kernel takes bf16 operands only")
    if any(t.device != zcol.device for t in tensors):
        raise ValueError("nice_net operands must lie on one device")
    m, k1 = zcol.shape
    hid, n = wp.shape
    if w1.shape != (k1, hid) or w2.shape != (hid, hid):
        raise ValueError(f"nice_net shapes: zcol {tuple(zcol.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, wp {tuple(wp.shape)}")
    if hid % 128:
        raise ValueError(f"nice_net kernel needs hidden % 128 == 0, got {hid}")
    k1p, n_p = -(-k1 // 16) * 16, -(-n // 16) * 16
    zcol_p = _pad_cols(zcol, k1p).contiguous()
    w1_p = F.pad(w1, (0, 0, 0, k1p - k1)).contiguous()
    w2_c = w2.contiguous()
    wp_p = _pad_cols(wp, n_p).contiguous()
    u = torch.empty((m, n_p), dtype=torch.float32, device=zcol.device)
    lib = _build.load()
    with torch.cuda.device(zcol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nice_net_u(zcol_p.data_ptr(), w1_p.data_ptr(), w2_c.data_ptr(),
                             wp_p.data_ptr(), u.data_ptr(), m, k1p, hid, n_p,
                             stream)
    _build.check(err, "nice_net_u")
    LAUNCHES["nice_net"] += 1
    return u[:, :n]


def nice_net_u(zcol, w1, w2, wp):
    """u = elu(elu(zcol @ w1) @ w2) @ wp: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if zcol.is_cuda:
        return nice_net_cuda(zcol, w1, w2, wp)
    if zcol.device.type != "cpu":
        raise ValueError(f"nice_net: unsupported device {zcol.device}")
    return nice_net_plain(zcol, w1, w2, wp)


def im2col3x3(z):
    """(B, H, W, C) -> (B*H*W, 9*C) SAME patches, dy-major, channels
    contiguous per tap (w1's HWIO order)."""
    b, hh, ww, c = z.shape
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([zp[:, dy:dy + hh, dx:dx + ww, :]
                      for dy in range(3) for dx in range(3)], dim=-1)
    return cols.reshape(b * hh * ww, 9 * c)


def nice_net_raw(params, z, h):
    """Fused ``NICE2d._raw``: the pre-transform net output (B, H, W, Cout).

    ``params``: the NICE2d param dict - w1 (3,3,C1,Hid), w2 (1,1,Hid,Hid),
    out {v (3,3,Hid+Ch,Cout), g, b}.  ``h``: conditioning (B,H,W,Ch) or None;
    its half of the out conv, ``conv3x3(elu(h)) @ w_out[Hid:]``, separates
    from the hidden half (ELU is elementwise over the concat) and runs here.
    """
    w1, w2 = params["w1"], params["w2"]
    v, g, b_out = params["out"]["v"], params["out"]["g"], params["out"]["b"]
    _, _, c1, hid = w1.shape
    cout = v.shape[-1]
    batch, hh, ww, _ = z.shape
    dt = z.dtype
    w_eff = (v * (g / _v_norm(v))).to(dt)  # (3, 3, Hid+Ch, Cout)
    wp = w_eff[:, :, :hid, :].permute(2, 0, 1, 3).reshape(hid, 9 * cout)
    u = nice_net_u(im2col3x3(z), w1.reshape(9 * c1, hid).to(dt),
                   w2[0, 0].to(dt), wp)
    raw = shifted_tap_sum(u.reshape(batch, hh, ww, 3, 3, cout), 3, 3)
    raw = raw.to(dt) + b_out
    if h is not None and w_eff.shape[2] > hid:
        raw = raw + plain_conv_apply(w_eff[:, :, hid:, :], F.elu(h.to(dt)),
                                     padding="SAME")
    return raw
