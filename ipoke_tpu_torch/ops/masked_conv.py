"""K2: the whole MaCowUnit inverse in one launch (replaces
``ipoke_tpu/ops/masked_conv.py::macow_unit_inverse_pallas``), and K5: the
inverse of one masked-conv flow (replaces ``masked_conv_inverse_pallas``).

A MaskedConvFlow's inverse is a recurrence over H dependent rows in scan
space: orders A/B as stored, C/D after an H<->W transpose and a swap of the
kernel axes.  A MaCowUnit is MCF(A) -> MCF(B) -> ActNorm -> MCF(C) -> MCF(D)
-> ActNorm.  K2 (``csrc/macow_unit_inverse.cu``) runs the unit's four
recurrences in a thread-block cluster per batch item, with the whole latent
in each CTA's shared memory, so it takes square latents up to what
``unit_fits`` allows (16x16 at C=32).  K5
(``csrc/masked_conv_inverse.cu``) runs one flow in a thread-block cluster
per batch item and keeps only a ring of the last kh rows on chip, so it
takes any number of rows; a flow whose weights or rows its shared memory
cannot hold goes to its streamed instance, which reads them from device
memory (``k5_streamed``).  The flows route every unit that K2 cannot take
through it, flow by flow.

``pack_mcf`` does the precompute that the JAX package also runs outside its
kernels: the kernel in scan space, the weight-norm 1x1 out conv split into
its hidden half ``w_hid`` and the per-pixel conditioning term ``hc = act(h)
@ w_h + b``; ``pack_unit`` stacks it for a unit's four flows and adds the
ActNorm inverses as (bias, 1 / (exp(log_scale) + 1e-8)).  Everything is
fp32, as on the TPU.  ``masked_conv_inverse_plain`` is one recurrence as a
row scan in plain PyTorch; ``macow_unit_inverse_plain`` runs four of them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build
from ..flows.primitives import _v_norm

# shared memory one block may opt into on an H100: 227 KB
SMEM_LIMIT = 232448


def _r4(n):
    return -(-n // 4) * 4


def pack_mcf(h_act, params, transposed, batch, height, width):
    """(w_shift (kh, kw, C, hid), w_hid (hid, P*C), hc (B, H, W, P*C)) of one
    MaskedConvFlow in scan space, fp32 (P: the transform's params per
    channel, 2 for affine).

    ``h_act``: the activation of the conditioning rows in fp32, or None.
    ``transposed``: orders C/D, which store their kernel with the dims
    swapped; swapping them back and transposing ``hc`` puts them in
    H<->W-transposed scan space.  ``height``, ``width``: the latent as
    stored."""
    f32 = torch.float32
    w_shift = params["w_shift"].to(f32)
    out = params["out"]
    v, g = out["v"].to(f32), out["g"].to(f32)
    w_out = (v * (g / _v_norm(v)))[0, 0]  # (hid + Ch, 2C)
    hid = w_shift.shape[-1]
    hc = out["b"].to(f32).expand(batch, height, width, w_out.shape[-1])
    if h_act is not None:
        hc = hc + torch.matmul(h_act, w_out[hid:])
    if transposed:
        return w_shift.transpose(0, 1), w_out[:hid], hc.transpose(1, 2)
    return w_shift, w_out[:hid], hc


def pack_unit(h, mcf_params, an_params, batch, height, width):
    """(w_shift (4,kh,kw,C,hid), w_hid (4,hid,2C), hc (4,B,H,W,2C),
    an_bias (2,C), an_inv (2,C)), all fp32 and contiguous.

    ``mcf_params``: [A, B, C, D] MaskedConvFlow param dicts (``pack_mcf``
    each).  ``an_params``: [AN1, AN2] ActNorm param dicts."""
    f32 = torch.float32
    h_act = None if h is None else F.elu(h.to(f32))
    w_shift, w_hid, hc = (torch.stack(t) for t in zip(*(
        pack_mcf(h_act, p, i >= 2, batch, height, width)
        for i, p in enumerate(mcf_params))))
    an_bias = torch.stack([p["bias"] for p in an_params]).to(f32)
    an_inv = torch.stack(
        [1.0 / (torch.exp(p["log_scale"].to(f32)) + 1e-8) for p in an_params])
    return w_shift, w_hid, hc, an_bias.contiguous(), an_inv.contiguous()


# ---------------------------------------------------------------------------
# K5: one masked-conv flow
# ---------------------------------------------------------------------------

def masked_conv_inverse_plain(y, w_shift, w_hid, hc, alpha, reverse, act=F.elu,
                              tr=None):
    """Plain version of K5: one masked-conv recurrence in scan space (rows
    depend on the rows before them, or after them when ``reverse``), with
    the elementwise activation ``act`` (ELU in the kernel).  ``tr``: a
    transform of ``flows.primitives`` in place of the kernel's affine one
    with ``alpha`` (the JAX package's portable scan for every other
    transform)."""
    b, height, width, c = y.shape
    kh, kw = w_shift.shape[0], w_shift.shape[1]
    cw = (kw - 1) // 2
    buf = y.new_zeros((b, height + kh, width + 2 * cw, c))
    w_conv = w_shift.permute(3, 2, 0, 1)  # OIHW
    for i in range(height):
        row = height - 1 - i if reverse else i
        start = row + 1 if reverse else row
        window = buf[:, start:start + kh].permute(0, 3, 1, 2)
        hid = F.conv2d(window, w_conv)[:, :, 0].transpose(1, 2)  # (b, W, hid)
        raw = torch.matmul(act(hid), w_hid) + hc[:, row]
        write_at = row if reverse else row + kh
        if tr is not None:
            buf[:, write_at, cw:cw + width] = tr.bwd(y[:, row], tr.calc(raw))
            continue
        mu, log_scale = raw[..., :c], raw[..., c:]
        scale = torch.tanh(log_scale * 0.5) * alpha + 1.0
        buf[:, write_at, cw:cw + width] = (y[:, row] - mu) / (scale + 1e-12)
    if reverse:
        return buf[:, :height, cw:cw + width]
    return buf[:, kh:, cw:cw + width]


# K5's launch (csrc/masked_conv_inverse.cu): a cluster of ``k5_cluster``
# CTAs of K5_THREADS threads per batch item, 8 lanes per hidden unit's tap
# dot, so at most K5_THREADS // 8 hidden units a CTA
K5_THREADS, K5_MAX_CLUSTER = 256, 8


def k5_cluster(hid):
    """K5's CTAs per batch item, by shape alone: the fewest (1, 2, 4 or 8)
    that hold ``hid`` hidden units at most 32 a CTA (rounded up to 4), else
    8 (the portable cluster; the CTA then takes its hidden units in passes
    of 32).  At the shipped widths (hid = 4C): 1 at C <= 8, 2 at C <= 16, 4
    above; 8 at hid 256 and 384."""
    k = 1
    while k < K5_MAX_CLUSTER and _r4(-(-hid // k)) > K5_THREADS // 8:
        k *= 2
    return k


def _k5_ring_bytes(width, c, hid, kh, kw, cluster):
    """The shared-memory instances' footprint per CTA (``smem_bytes`` in
    K5's source): 16 bytes of mbarrier, then the CTA's weight slice (hk =
    hid/cluster hidden units, rounded up to 4), a ring of kh padded rows (W
    rounded up to 8 plus kw - 1 columns, C rounded up to 4), one row of the
    CTA's hiddens and two buffers of the row's partial products, each
    region rounded up to 16 bytes.  Independent of the number of rows."""
    hk, cp = _r4(-(-hid // cluster)), _r4(c)
    wpad = -(-width // 8) * 8 + kw - 1
    floats = (kh * kw * c * hk + hk * 2 * c + _r4(kh * wpad * cp)
              + _r4(width * (hk + 4)) + _r4(4 * width * c))
    return 16 + 4 * floats


# the streamed instance's shared memory: one reduction buffer of
# K5_THREADS x 8 floats (``STREAMED_SMEM`` in K5's source)
K5_STREAMED_SMEM = 4 * K5_THREADS * 8


def _k5_staged_bytes(width, c, hid, kh):
    """The streamed instance's footprint with its row staged
    (``staged_smem_bytes`` in K5's source): the reduction buffer, the kh
    input rows of W + 2 columns (rounded up to 4 floats) and the row's
    whole hiddens (W, hid)."""
    return K5_STREAMED_SMEM + 4 * (_r4(kh * (width + 2) * c) + width * hid)


def k5_streamed(width, c, hid, kh, kw, cluster):
    """Whether K5 takes a flow on its streamed instance (``in_smem`` in its
    source, negated): a row of more than 1024 elements (W * C), or the
    shared-memory instances' footprint (``_k5_ring_bytes``, the CTA's
    weight slice above all) past ``SMEM_LIMIT``.  The streamed instance
    keeps the tap weights in device memory (L2) and the row's hiddens in a
    (B, W, hid) scratch, staging a row's inputs and hiddens in shared
    memory where they fit, so it has no limit of its own."""
    return (width * c > 4 * K5_THREADS
            or _k5_ring_bytes(width, c, hid, kh, kw, cluster) > SMEM_LIMIT)


def k5_smem_bytes(width, c, hid, kh, kw, cluster):
    """K5's shared memory per CTA on the instance it takes at this shape
    (``masked_conv_inverse_smem_bytes`` in its source): the weight slice,
    ring and row buffers of ``_k5_ring_bytes``; on the streamed instance
    its staged row (``_k5_staged_bytes``) where that fits ``SMEM_LIMIT``,
    else its reduction buffer alone."""
    if k5_streamed(width, c, hid, kh, kw, cluster):
        staged = _k5_staged_bytes(width, c, hid, kh)
        return staged if staged <= SMEM_LIMIT else K5_STREAMED_SMEM
    return _k5_ring_bytes(width, c, hid, kh, kw, cluster)


def k5_registers(c, hid, kh):
    """Whether K5 keeps a lane's tap weights in registers (``in_registers``
    in its source): at most 16 tap groups, kh * ceil(C/4) <= 16 (C <= 32
    at kernel (2, 3)), at most 32 hidden units a CTA and 2C within the
    CTA's threads.  Otherwise its wide path streams them from shared
    memory, group by group."""
    hk = _r4(-(-hid // k5_cluster(hid)))
    return kh * _r4(c) // 4 <= 16 and hk <= K5_THREADS // 8 and 2 * c <= K5_THREADS


def k5_fits(shape, hid, kernel_size):
    """Whether K5 takes one flow on a scan-space latent of ``shape`` (B, H,
    W, C), by shape alone (``takes`` in its source): hid is a multiple of 4
    (16-byte bulk copies of the weight slices) and kw is 3, as every config
    sets both.  Any number of rows, any row width and any hid: where its
    shared-memory instances cannot hold the flow, the streamed one takes it
    (``k5_streamed``)."""
    kh, kw = kernel_size
    return hid % 4 == 0 and kw == 3 and min(shape) > 0 and kh > 0


def masked_conv_inverse_cuda(y, w_shift, w_hid, hc, alpha, reverse):
    """Launch K5 on fp32 inputs in scan space (one CUDA device, a shape that
    ``k5_fits``).  K5 has no backward, as in the JAX package: it raises
    while autograd records through an input that requires grad."""
    tensors = (y, w_shift, w_hid, hc)
    _build.refuse_grad("masked_conv_inverse", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("masked_conv_inverse kernel takes fp32 inputs only")
    if any(t.device != y.device for t in tensors):
        raise ValueError("masked_conv_inverse inputs must lie on one device")
    b, height, width, c = y.shape
    kh, kw, _, hid = w_shift.shape
    if w_shift.shape[2] != c or w_hid.shape != (hid, 2 * c) \
            or hc.shape != (b, height, width, 2 * c):
        raise ValueError(
            f"masked_conv_inverse shapes: y {tuple(y.shape)}, w_shift "
            f"{tuple(w_shift.shape)}, w_hid {tuple(w_hid.shape)}, hc {tuple(hc.shape)}")
    k = k5_cluster(hid)
    if not k5_fits(y.shape, hid, (kh, kw)):
        raise ValueError(
            f"masked_conv_inverse: scan-space latent {tuple(y.shape)} with "
            f"kernel ({kh}, {kw}) and hid {hid} is not a shape K5 takes "
            f"(k5_fits: hid a multiple of 4 and kw 3)")
    # contiguous, aligned copies are held here until the launch is queued
    y, w_shift, w_hid, hc = (_build.aligned(t) for t in tensors)
    x = torch.empty_like(y)
    # the streamed instance's row of hiddens, (B, W, hid)
    scratch = torch.empty((b, width, hid), dtype=torch.float32, device=y.device) \
        if k5_streamed(width, c, hid, kh, kw, k) else None
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.masked_conv_inverse(
            y.data_ptr(), w_shift.data_ptr(), w_hid.data_ptr(), hc.data_ptr(),
            x.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, height, width, c, hid, kh, kw, float(alpha), int(reverse), k, stream)
    _build.check(err, "masked_conv_inverse")
    LAUNCHES["masked_conv_inverse"] += 1
    return x


def scan_inverse(run, y, h_act, params, order, alpha):
    """The inverse of one masked-conv flow of ``order`` by ``run``, a
    recurrence in scan space with ``masked_conv_inverse_plain``'s arguments;
    ``h_act`` is act(h) in fp32, or None.  fp32 result, as stored."""
    if order not in ("A", "B", "C", "D"):
        raise ValueError(f"masked-conv order {order!r}")
    transposed = order in ("C", "D")
    ys = (y.transpose(1, 2) if transposed else y).to(torch.float32)
    b, height, width, _ = y.shape
    packed = pack_mcf(h_act, params, transposed, b, height, width)
    xs = run(ys, *packed, alpha, order in ("B", "D"))
    return xs.transpose(1, 2) if transposed else xs


def masked_conv_inverse(y, h, params, order, alpha=1.0):
    """Inverse of one MaskedConvFlow (affine transform, ELU, orders A-D, any
    latent), fp32 result.  K5 for CUDA tensors, its plain version for CPU
    tensors."""
    if y.is_cuda:
        run = masked_conv_inverse_cuda
    elif y.device.type == "cpu":
        run = masked_conv_inverse_plain
    else:
        raise ValueError(f"masked_conv_inverse: unsupported device {y.device}")
    h_act = None if h is None else F.elu(h.to(torch.float32))
    return scan_inverse(run, y, h_act, params, order, alpha)


# ---------------------------------------------------------------------------
# K2: one whole MaCowUnit
# ---------------------------------------------------------------------------

# K2's launch (csrc/macow_unit_inverse.cu): a cluster of K2_CLUSTER CTAs of
# K2_THREADS threads per batch item, 8 lanes per hidden unit's tap dot
K2_CLUSTER, K2_THREADS = 4, 256


def k2_smem_bytes(height, width, c, hid, kh, kw):
    """K2's shared memory per CTA (``smem_bytes`` in its source): 16 bytes of
    mbarriers, then two buffers of one flow's weight slice (the CTA's hk =
    hid/4 hidden units, rounded up to 4), the padded latent (H + kh rows,
    W rounded up to 8 plus kw - 1 columns, C rounded up to 4), the
    recurrence's input, one row of the CTA's hiddens and two buffers of the
    row's partial products, each region rounded up to 16 bytes."""
    hk, cp = _r4(-(-hid // K2_CLUSTER)), _r4(c)
    wpad = -(-width // 8) * 8 + kw - 1
    floats = (2 * (kh * kw * c * hk + hk * 2 * c) + _r4((height + kh) * wpad * cp)
              + _r4(height * width * c) + _r4(width * (hk + 4)) + _r4(4 * width * c))
    return 16 + 4 * floats


def unit_fits(shape, hid, kernel_size):
    """Whether K2 takes a unit on a latent of ``shape`` (B, H, W, C), by shape
    alone (``takes`` and the shared-memory check in its source): the latent
    is square; hid is a multiple of 4 (16-byte bulk copies of the weight
    slices) and at most 32 per CTA (8 lanes per hidden unit in 256
    threads); kw is 3, as every config sets it, and kh * ceil(C/4) <= 16
    (a lane's tap weights in registers); W * C <= 1024 (4 affine elements per thread); and
    ``k2_smem_bytes`` is within ``SMEM_LIMIT``.  At the shipped widths
    (C = 32, 30, ..., 4, hid = 4C, kernel (2, 3)) that is every square
    latent up to 16x16.  Every other unit is inverted flow by flow through
    K5."""
    _, height, width, c = shape
    kh, kw = kernel_size
    return (height == width and hid % 4 == 0
            and _r4(-(-hid // K2_CLUSTER)) <= K2_THREADS // 8
            and kw == 3 and kh * _r4(c) // 4 <= 16
            and width * c <= 4 * K2_THREADS
            and k2_smem_bytes(height, width, c, hid, kh, kw) <= SMEM_LIMIT)


def macow_unit_inverse_plain(y, w_shift, w_hid, hc, an_bias, an_inv, alpha):
    """Plain version of K2 on the packed fp32 inputs: AN2^-1, MCF-D, MCF-C
    (transposed space), AN1^-1, MCF-B, MCF-A."""
    scan = masked_conv_inverse_plain
    x = (y - an_bias[1]) * an_inv[1]
    xt = scan(x.transpose(1, 2), w_shift[3], w_hid[3], hc[3], alpha, True)
    xt = scan(xt, w_shift[2], w_hid[2], hc[2], alpha, False)
    x = (xt.transpose(1, 2) - an_bias[0]) * an_inv[0]
    x = scan(x, w_shift[1], w_hid[1], hc[1], alpha, True)
    return scan(x, w_shift[0], w_hid[0], hc[0], alpha, False)


def macow_unit_inverse_cuda(y, w_shift, w_hid, hc, an_bias, an_inv, alpha):
    """Launch K2 on the packed fp32 inputs (one CUDA device, a latent that
    ``unit_fits``).  K2 has no backward, as in the JAX package: it raises
    while autograd records through an input that requires grad."""
    tensors = (y, w_shift, w_hid, hc, an_bias, an_inv)
    _build.refuse_grad("macow_unit_inverse", *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("macow_unit_inverse kernel takes fp32 inputs only")
    if any(t.device != y.device for t in tensors):
        raise ValueError("macow_unit_inverse inputs must lie on one device")
    b, height, width, c = y.shape
    _, kh, kw, _, hid = w_shift.shape
    if w_shift.shape != (4, kh, kw, c, hid) or w_hid.shape != (4, hid, 2 * c) \
            or hc.shape != (4, b, height, width, 2 * c) \
            or an_bias.shape != (2, c) or an_inv.shape != (2, c):
        raise ValueError(
            f"macow_unit_inverse shapes: y {tuple(y.shape)}, w_shift "
            f"{tuple(w_shift.shape)}, w_hid {tuple(w_hid.shape)}, hc {tuple(hc.shape)}")
    if not unit_fits(y.shape, hid, (kh, kw)):
        raise ValueError(
            f"macow_unit_inverse: latent {tuple(y.shape)} with hid {hid} and "
            f"kernel ({kh}, {kw}) is not a shape K2 takes (unit_fits)")
    # contiguous, aligned copies are held here until the launch is queued
    y, w_shift, w_hid, hc, an_bias, an_inv = (_build.aligned(t) for t in tensors)
    x = torch.empty_like(y)
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.macow_unit_inverse(
            y.data_ptr(), w_shift.data_ptr(), w_hid.data_ptr(), hc.data_ptr(),
            an_bias.data_ptr(), an_inv.data_ptr(), x.data_ptr(),
            b, height, width, c, hid, kh, kw, float(alpha), stream)
    _build.check(err, "macow_unit_inverse")
    LAUNCHES["macow_unit_inverse"] += 1
    return x


def macow_unit_inverse(y, h, mcf_params, an_params, kernel_size, alpha=1.0):
    """Inverse of one MaCowUnit (affine transform, ELU, a latent that
    ``unit_fits``), fp32 result.  K2 for CUDA tensors, the plain version for
    CPU tensors.  ``kernel_size`` is the unit's (kh, kw) as configured."""
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
