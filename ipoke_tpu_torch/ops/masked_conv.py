"""K2: the whole MaCowUnit inverse in one launch (replaces
``ipoke_tpu/ops/masked_conv.py::macow_unit_inverse_pallas``).

A MaCowUnit is MCF(A) -> MCF(B) -> ActNorm -> MCF(C) -> MCF(D) -> ActNorm.
Its inverse runs four masked-conv recurrences of H dependent rows each; the
kernel (``csrc/macow_unit_inverse.cu``) keeps the activation buffer on chip
across all four.  Orders C/D run in H<->W-transposed space (square latents).
``pack_unit`` does the precompute that the JAX package also runs outside its
kernel: C/D kernels swapped back, the weight-norm 1x1 out conv split into its
hidden half ``w_hid`` and the per-pixel conditioning term ``hc = elu(h) @ w_h
+ b``, and the ActNorm inverses as (bias, 1 / (exp(log_scale) + 1e-8)).
Everything is fp32, as on the TPU.  ``macow_unit_inverse_plain`` is the same
computation as row scans in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build
from ..flows.primitives import _v_norm


def pack_unit(h, mcf_params, an_params, batch, height, width):
    """(w_shift (4,kh,kw,C,hid), w_hid (4,hid,2C), hc (4,B,H,W,2C),
    an_bias (2,C), an_inv (2,C)), all fp32 and contiguous.

    ``mcf_params``: [A, B, C, D] MaskedConvFlow param dicts; C/D store their
    kernel with the dims swapped, and swapping them back puts C/D in
    transposed scan space.  ``an_params``: [AN1, AN2] ActNorm param dicts."""
    f32 = torch.float32
    w_shift = torch.stack([
        p["w_shift"].transpose(0, 1) if i >= 2 else p["w_shift"]
        for i, p in enumerate(mcf_params)]).to(f32)
    hid = w_shift.shape[-1]
    h32 = None if h is None else F.elu(h.to(f32))
    w_hids, hcs = [], []
    for i, p in enumerate(mcf_params):
        out = p["out"]
        v, g = out["v"].to(f32), out["g"].to(f32)
        w_out = (v * (g / _v_norm(v)))[0, 0]  # (hid + Ch, 2C)
        w_hids.append(w_out[:hid])
        hc = out["b"].to(f32).expand(batch, height, width, w_out.shape[-1])
        if h32 is not None:
            hc = hc + torch.matmul(h32, w_out[hid:])
        if i >= 2:  # C/D run in H<->W-transposed scan space
            hc = hc.transpose(1, 2)
        hcs.append(hc)
    an_bias = torch.stack([p["bias"] for p in an_params]).to(f32)
    an_inv = torch.stack(
        [1.0 / (torch.exp(p["log_scale"].to(f32)) + 1e-8) for p in an_params])
    return (w_shift.contiguous(), torch.stack(w_hids).contiguous(),
            torch.stack(hcs).contiguous(), an_bias.contiguous(),
            an_inv.contiguous())


def _rowscan(cur, w_shift, w_hid, hc, alpha, reverse):
    """One masked-conv recurrence in scan space (rows depend on the rows
    before them, or after them when ``reverse``), as
    ``MaskedConvFlow._inverse_height``."""
    b, height, width, c = cur.shape
    kh, kw = w_shift.shape[0], w_shift.shape[1]
    cw = (kw - 1) // 2
    buf = cur.new_zeros((b, height + kh, width + 2 * cw, c))
    w_conv = w_shift.permute(3, 2, 0, 1)  # OIHW
    for i in range(height):
        row = height - 1 - i if reverse else i
        start = row + 1 if reverse else row
        window = buf[:, start:start + kh].permute(0, 3, 1, 2)
        hid = F.conv2d(window, w_conv)[:, :, 0].transpose(1, 2)  # (b, W, hid)
        raw = torch.matmul(F.elu(hid), w_hid) + hc[:, row]
        mu, log_scale = raw[..., :c], raw[..., c:]
        scale = torch.tanh(log_scale * 0.5) * alpha + 1.0
        write_at = row if reverse else row + kh
        buf[:, write_at, cw:cw + width] = (cur[:, row] - mu) / (scale + 1e-12)
    if reverse:
        return buf[:, :height, cw:cw + width]
    return buf[:, kh:, cw:cw + width]


def macow_unit_inverse_plain(y, w_shift, w_hid, hc, an_bias, an_inv, alpha):
    """Plain version of the kernel on the packed fp32 inputs: AN2^-1, MCF-D,
    MCF-C (transposed space), AN1^-1, MCF-B, MCF-A."""
    x = (y - an_bias[1]) * an_inv[1]
    xt = _rowscan(x.transpose(1, 2), w_shift[3], w_hid[3], hc[3], alpha, True)
    xt = _rowscan(xt, w_shift[2], w_hid[2], hc[2], alpha, False)
    x = (xt.transpose(1, 2) - an_bias[0]) * an_inv[0]
    x = _rowscan(x, w_shift[1], w_hid[1], hc[1], alpha, True)
    return _rowscan(x, w_shift[0], w_hid[0], hc[0], alpha, False)


def macow_unit_inverse_cuda(y, w_shift, w_hid, hc, an_bias, an_inv, alpha):
    """Launch the kernel on the packed fp32 inputs (one CUDA device)."""
    tensors = (y, w_shift, w_hid, hc, an_bias, an_inv)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("macow_unit_inverse kernel takes fp32 inputs only")
    if any(t.device != y.device for t in tensors):
        raise ValueError("macow_unit_inverse inputs must lie on one device")
    b, height, width, c = y.shape
    _, kh, kw, _, hid = w_shift.shape
    if height != width or w_hid.shape != (4, hid, 2 * c) \
            or hc.shape != (4, b, height, width, 2 * c):
        raise ValueError(
            f"macow_unit_inverse shapes: y {tuple(y.shape)}, w_shift "
            f"{tuple(w_shift.shape)}, w_hid {tuple(w_hid.shape)}, hc {tuple(hc.shape)}")
    y = y.contiguous()
    x = torch.empty_like(y)
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.macow_unit_inverse(
            y.data_ptr(), w_shift.contiguous().data_ptr(),
            w_hid.contiguous().data_ptr(), hc.contiguous().data_ptr(),
            an_bias.contiguous().data_ptr(), an_inv.contiguous().data_ptr(),
            x.data_ptr(), b, height, width, c, hid, kh, kw, float(alpha), stream)
    _build.check(err, "macow_unit_inverse")
    LAUNCHES["macow_unit_inverse"] += 1
    return x


def macow_unit_inverse(y, h, mcf_params, an_params, kernel_size, alpha=1.0):
    """Inverse of one MaCowUnit (affine transform, ELU, square latents),
    fp32 result.  The kernel for CUDA tensors, the plain version for CPU
    tensors.  ``kernel_size`` is the unit's (kh, kw) as configured."""
    b, height, width, _ = y.shape
    packed = pack_unit(h, mcf_params, an_params, b, height, width)
    if tuple(packed[0].shape[1:3]) != tuple(kernel_size):
        raise ValueError(f"w_shift taps {tuple(packed[0].shape[1:3])} != "
                         f"kernel_size {tuple(kernel_size)}")
    y32 = y.to(torch.float32)
    if y.is_cuda:
        return macow_unit_inverse_cuda(y32, *packed, alpha)
    if y.device.type != "cpu":
        raise ValueError(f"macow_unit_inverse: unsupported device {y.device}")
    return macow_unit_inverse_plain(y32, *packed, alpha)
