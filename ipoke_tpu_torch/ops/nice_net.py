"""K1 and K4: the fused NICE coupling net, for inference (replaces
``ipoke_tpu/ops/nice_net.py::nice_net_raw_pallas``) and for training
(replaces ``_train_impl`` under ``nice_net_raw_train``).

Every NICE coupling of the cINN evaluates w1 (3x3 conv) -> ELU -> w2 (1x1,
hidden x hidden) -> ELU -> out (3x3 weight-norm conv, skinny).  The kernel
(``csrc/nice_net.cu``) computes the three contractions of that chain,

    u = elu(elu(zcol @ w1) @ w2) @ wp        (bf16 operands, fp32 sums)

with ``zcol`` the 3x3 im2col of the coupling input and ``wp`` the tap-packed
out weight, in three launches that write the post-ELU hiddens a and b
to device memory (they stay in L2) and then u.  The im2col,
the shifted-add epilogue of the tap-packed conv, the bias and the
h-conditioning half of the out conv run here in torch, as the JAX package
runs them outside its kernel.  ``nice_net_plain`` is the same chain in
plain PyTorch.

K4 is the same launches, returning a and b as well (for K1 they are
scratch; ``nice_net_train_plain`` beside it), inside ``_NiceNetTrain``, an
autograd Function whose backward is the JAX package's hand-written one.

On a rank of a dp x tp mesh (``ipoke_tpu_torch/parallel``) a coupling
holds a shard of w2, Hid/tp of its output columns.  The same three
launches then run at the shard's shapes (S = 2 at N = Hid/tp, S = 3 at K =
Hid/tp over the rows of wp of the rank's hidden units), and one all-reduce
of the fp32 tap-summed output closes the coupling (``nice_net_raw`` with a
mesh).  ``_NiceNetTrainSplit`` is K4's split form: its backward runs the
four products on the shard, sums the first hidden's gradient over the
model axis once, and the out weight's hidden rows once (Megatron's f/g
pair).  ``nice_net_raw_split_plain`` is the split coupling in plain
PyTorch, through autograd, for the couplings outside K1's family.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build
from ..flows.primitives import (
    _v_norm,
    conv1x1_dot,
    plain_conv_apply,
    shifted_tap_sum,
    wn_conv_apply_packed,
)


def nice_net_fits(params, z, h) -> bool:
    """The JAX package's static shape family for the kernel
    (``nice_net_fits``) without its TPU VMEM budget: 3x3 in and out convs,
    a 1x1 w2, a hidden width that is a multiple of 128 (on a rank of the
    mesh, the shard's: w2's columns), at most 512 pixels per image, and
    ``h`` given when the out conv has conditioning rows."""
    w1, v = params["w1"], params["out"]["v"]
    kh, kw, _, hid = w1.shape
    if (kh, kw) != (3, 3) or tuple(v.shape[:2]) != (3, 3) \
            or tuple(params["w2"].shape[:2]) != (1, 1):
        return False
    if hid % 128 != 0 or params["w2"].shape[-1] % 128 != 0 \
            or z.shape[1] * z.shape[2] > 512:
        return False
    return not (v.shape[2] > hid and h is None)


def _elu_f32(a):
    return torch.where(a > 0, a, torch.expm1(torch.clamp(a, max=0.0)))


def nice_net_train_plain(zcol, w1, w2, wp):
    """Plain version of the kernels: every product in fp32 over the bf16
    operands, ELU on the fp32 sums, rounded to the operand dtype before the
    next product, as the TPU kernel does.  Returns (u fp32, a, b), the
    post-ELU hiddens in the operand dtype."""
    dt = zcol.dtype
    a = _elu_f32(torch.matmul(zcol.float(), w1.float())).to(dt)
    b = _elu_f32(torch.matmul(a.float(), w2.float())).to(dt)
    return torch.matmul(b.float(), wp.float()), a, b


def nice_net_plain(zcol, w1, w2, wp):
    """Plain version of K1: u of ``nice_net_train_plain``."""
    return nice_net_train_plain(zcol, w1, w2, wp)[0]


def _pad_cols(t, n):
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def _launch(zcol, w1, w2, wp, train: bool):
    """Launch K1 (``train=False``: returns u) or K4 (returns u, a, b):
    ``zcol`` (M, K1), ``w1`` (K1, Hid), ``w2`` (Hid, Hs), ``wp`` (Hs, N),
    all bf16 on one CUDA device (Hs = Hid, or a mesh rank's shard of the
    hidden width); u is (M, N) fp32, a (M, Hid) and b (M, Hs) bf16.
    K1 and N are zero-padded to multiples of 16 here.  Both are the same
    three CUDA launches (a, b, then u; ``csrc/nice_net.cu``), so K4's u is
    K1's bit for bit; ``LAUNCHES`` counts wrapper calls."""
    name = "nice_net_train" if train else "nice_net"
    tensors = (zcol, w1, w2, wp)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{name} kernel takes bf16 operands only")
    if any(t.device != zcol.device for t in tensors):
        raise ValueError(f"{name} operands must lie on one device")
    m, k1 = zcol.shape
    hid, hs, n = w1.shape[1], wp.shape[0], wp.shape[1]
    if w1.shape != (k1, hid) or w2.shape != (hid, hs):
        raise ValueError(f"{name} shapes: zcol {tuple(zcol.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, wp {tuple(wp.shape)}")
    if hid % 128 or hs % 128:
        raise ValueError(f"{name} kernel needs hidden % 128 == 0, got {hid} / {hs}")
    k1p, n_p = -(-k1 // 16) * 16, -(-n // 16) * 16
    zcol_p = _pad_cols(zcol, k1p).contiguous()
    w1_p = F.pad(w1, (0, 0, 0, k1p - k1)).contiguous()
    w2_c = w2.contiguous()
    wp_p = _pad_cols(wp, n_p).contiguous()
    u = torch.empty((m, n_p), dtype=torch.float32, device=zcol.device)
    # the hiddens: K4's residuals, K1's scratch (the kernel writes both)
    a = torch.empty((m, hid), dtype=torch.bfloat16, device=zcol.device)
    b = torch.empty((m, hs), dtype=torch.bfloat16, device=zcol.device)
    lib = _build.load()
    with torch.cuda.device(zcol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nice_net_u_split(zcol_p.data_ptr(), w1_p.data_ptr(), w2_c.data_ptr(),
                                   wp_p.data_ptr(), u.data_ptr(), a.data_ptr(),
                                   b.data_ptr(), m, k1p, hid, hs, n_p, stream)
    _build.check(err, name)
    LAUNCHES[name] += 1
    return (u[:, :n], a, b) if train else u[:, :n]


def nice_net_cuda(zcol, w1, w2, wp):
    """Launch K1; see ``_launch``.  K1 has no backward, as in the JAX
    package (K4 is the differentiable form): it raises while autograd
    records through an input that requires grad."""
    _build.refuse_grad("nice_net", zcol, w1, w2, wp)
    return _launch(zcol, w1, w2, wp, train=False)


def nice_net_train_cuda(zcol, w1, w2, wp):
    """Launch K4; see ``_launch``."""
    return _launch(zcol, w1, w2, wp, train=True)


def _on_device(kernel, plain, zcol, *rest):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if zcol.is_cuda:
        return kernel(zcol, *rest)
    if zcol.device.type != "cpu":
        raise ValueError(f"nice_net: unsupported device {zcol.device}")
    return plain(zcol, *rest)


def nice_net_u(zcol, w1, w2, wp):
    """u = elu(elu(zcol @ w1) @ w2) @ wp (K1 on CUDA tensors)."""
    return _on_device(nice_net_cuda, nice_net_plain, zcol, w1, w2, wp)


def nice_net_train_u(zcol, w1, w2, wp):
    """(u, a, b): u and the post-ELU hiddens (K4 on CUDA tensors)."""
    return _on_device(nice_net_train_cuda, nice_net_train_plain, zcol, w1, w2, wp)


def im2col3x3(z):
    """(B, H, W, C) -> (B*H*W, 9*C) SAME patches, dy-major, channels
    contiguous per tap (w1's HWIO order)."""
    b, hh, ww, c = z.shape
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([zp[:, dy:dy + hh, dx:dx + ww, :]
                      for dy in range(3) for dx in range(3)], dim=-1)
    return cols.reshape(b * hh * ww, 9 * c)


def _shard_rows(mesh, hid, hs):
    """The rows of the out weight's hidden half that the rank's shard of
    ``hs`` hidden units reads: all ``hid`` without a mesh."""
    r = 0 if mesh is None else mesh.index("model")
    return slice(r * hs, (r + 1) * hs)


def _operands(params, z, mesh=None):
    """The kernels' operands from a NICE2d param dict: (zcol, w1 (9*C1, Hid),
    w2 (Hid, Hs), the tap-packed hidden half of the weight-normed out conv
    wp (Hs, 9*Cout)), all in z's dtype, and the whole out weight w_eff.  Hs
    = Hid, or on a mesh rank the shard's width (w2's columns), wp then the
    rows of the rank's hidden units."""
    w1, w2, v, g = params["w1"], params["w2"], params["out"]["v"], params["out"]["g"]
    _, _, c1, hid = w1.shape
    hs = w2.shape[-1]
    dt = z.dtype
    w_eff = (v * (g / _v_norm(v))).to(dt)  # (3, 3, Hid+Ch, Cout)
    wp = w_eff[:, :, _shard_rows(mesh, hid, hs), :].permute(2, 0, 1, 3).reshape(hs, -1)
    return im2col3x3(z), w1.reshape(9 * c1, hid).to(dt), w2[0, 0].to(dt), wp, w_eff


def _epilogue(u, w_eff, b_out, z, h, hid, mesh=None):
    """Shifted-add of the tap-packed out conv, bias, and the h-conditioning
    half of the out conv, ``conv3x3(elu(h)) @ w_out[Hid:]``, which
    separates from the hidden half (ELU is elementwise over the concat).
    On a mesh rank the fp32 tap sum of its hidden units is summed over the
    model axis first (the coupling's one all-reduce)."""
    batch, hh, ww, _ = z.shape
    raw = shifted_tap_sum(u.reshape(batch, hh, ww, 3, 3, -1), 3, 3)
    if mesh is not None:
        from ..parallel.comm import reduce_from_model

        raw = reduce_from_model(raw, mesh)
    raw = raw.to(z.dtype) + b_out
    if h is not None and w_eff.shape[2] > hid:
        raw = raw + plain_conv_apply(w_eff[:, :, hid:, :], F.elu(h.to(z.dtype)),
                                     padding="SAME")
    return raw


def nice_net_raw(params, z, h, mesh=None):
    """Fused ``NICE2d._raw`` through K1: the pre-transform net output
    (B, H, W, Cout).

    ``params``: the NICE2d param dict - w1 (3,3,C1,Hid), w2 (1,1,Hid,Hid),
    out {v (3,3,Hid+Ch,Cout), g, b}.  ``h``: conditioning (B,H,W,Ch) or
    None.  ``mesh``: the mesh whose model axis splits the hidden width,
    where w2 holds the rank's Hid/tp columns."""
    zcol, w1, w2, wp, w_eff = _operands(params, z, mesh)
    return _epilogue(nice_net_u(zcol, w1, w2, wp), w_eff, params["out"]["b"],
                     z, h, w1.shape[-1], mesh)


# ---------------------------------------------------------------------------
# K4: the differentiable fused path of the density forward
# ---------------------------------------------------------------------------

def _train_forward(params, z, h):
    """K4's forward (``_train_impl`` of the JAX package): (raw, a, b), the
    ``nice_net_raw`` output and the post-ELU hiddens, (B*H*W, Hid) each."""
    zcol, w1, w2, wp, w_eff = _operands(params, z)
    u, a, b = nice_net_train_u(zcol, w1, w2, wp)
    return _epilogue(u, w_eff, params["out"]["b"], z, h, w1.shape[-1]), a, b


def _mm32(x, y):
    """x @ y with fp32 sums and an fp32 result (cuBLAS's fp32 output on
    CUDA; fp32 operands on the CPU)."""
    if x.is_cuda:
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.matmul(x.float(), y.float())


def _mm(x, y):
    """x @ y with fp32 sums, rounded once to x's dtype, as the JAX package's
    dots with ``preferred_element_type=float32``.  On CUDA the product asks
    cuBLAS for an fp32 output, so that no split-K partial is rounded to bf16
    (a bf16-output matmul may do that under PyTorch's default
    ``allow_bf16_reduced_precision_reduction``); on the CPU it runs in
    fp32."""
    if x.is_cuda:
        return torch.mm(x, y, out_dtype=torch.float32).to(x.dtype)
    return torch.matmul(x.float(), y.float()).to(x.dtype)


def _elu_bwd(post, g):
    """Cotangent through ELU from the POST-activation value: elu'(x) is 1
    for x > 0 and exp(x) = elu(x) + 1 otherwise."""
    return g * torch.where(post > 0, torch.ones_like(post), post + 1)


def _tail(out_params, h, b4d):
    """The plain tail of ``NICE2d._raw``: the weight-norm packed out conv
    over concat([post-ELU hidden, elu(h)]); its autograd gives the out-conv,
    bias and h-branch adjoints."""
    x = b4d if h is None else torch.cat([b4d, F.elu(h.to(b4d.dtype))], dim=-1)
    return wn_conv_apply_packed(out_params, x)


class _NiceNetTrain(torch.autograd.Function):
    """K4 forward (the K1 chain storing the post-ELU hiddens a and b) with
    the JAX package's hand-written backward (``_nice_train_bwd``): the four
    big products over the stored a and b, each an fp32 sum rounded to the
    working dtype; the tail and the im2col adjoints through autograd."""

    @staticmethod
    def forward(ctx, z, h, w1, w2, v, g, b_out):
        params = {"w1": w1, "w2": w2, "out": {"v": v, "g": g, "b": b_out}}
        raw, a, b = _train_forward(params, z, h)
        ctx.save_for_backward(z, h, w1, w2, v, g, b_out, a, b)
        return raw

    @staticmethod
    def backward(ctx, grad):
        z, h, w1, w2, v, g, b_out, a, b = ctx.saved_tensors
        dt = z.dtype
        hid = w1.shape[-1]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (v, g, b_out)]
            b4d = b.reshape(*z.shape[:3], hid).detach().requires_grad_()
            hd = None if h is None else h.detach().requires_grad_()
            out = dict(zip(("v", "g", "b"), leaves))
            inputs = leaves + [b4d] + ([] if hd is None else [hd])
            dv, dg, db_out, db4d, *dh = torch.autograd.grad(
                _tail(out, hd, b4d), inputs, grad)
        db_pre = _elu_bwd(b, db4d.reshape(-1, hid))
        dw2 = _mm(a.t(), db_pre)
        da_pre = _elu_bwd(a, _mm(db_pre, w2[0, 0].to(dt).t()))
        zcol = im2col3x3(z)
        dw1 = _mm(zcol.t(), da_pre)
        dzcol = _mm(da_pre, w1.reshape(-1, hid).to(dt).t())
        with torch.enable_grad():
            zd = z.detach().requires_grad_()
            dz, = torch.autograd.grad(im2col3x3(zd), zd, dzcol)
        return (dz, dh[0] if dh else None, dw1.reshape(w1.shape).to(w1.dtype),
                dw2[None, None].to(w2.dtype), dv, dg, db_out)


def nice_net_raw_train(params, z, h):
    """Differentiable fused ``NICE2d._raw`` for the density forward of
    training (``nice_net_raw_train`` of the JAX package): K4 forward,
    hand-written backward.  Called only while autograd records; without it
    ``nice_net_raw`` (K1) computes the same output bitwise."""
    out = params["out"]
    return _NiceNetTrain.apply(z, h, params["w1"], params["w2"], out["v"],
                               out["g"], out["b"])


# ---------------------------------------------------------------------------
# The split coupling of a dp x tp mesh rank
# ---------------------------------------------------------------------------

def _split_tail(out_params, h, b4d, mesh, hid, act=F.elu, reduce=True):
    """The out conv of a rank's hidden shard ``b4d`` (B, H, W, Hs): the
    weight-normed out weight whole (its norm over the whole contraction
    axis), its hidden rows behind ``copy_to_model`` (their gradient summed
    over the model axis), the rank's rows' tap-packed product and shifted
    sum in fp32, summed over the model axis (``reduce``; the identity in
    backward, so a backward pass may leave it out), rounded, the bias and
    the h-conditioning half."""
    from ..parallel.comm import copy_to_model, reduce_from_model

    v, g, bias = out_params["v"], out_params["g"], out_params["b"]
    dt = b4d.dtype
    bsz, hh, ww, hs = b4d.shape
    w = (v * (g / _v_norm(v))).to(dt)
    wh = copy_to_model(w[:, :, :hid, :], mesh)[:, :, _shard_rows(mesh, hid, hs), :]
    wp = wh.permute(2, 0, 1, 3).reshape(hs, -1)
    u = torch.matmul(b4d.reshape(-1, hs).float(), wp.float())
    raw = shifted_tap_sum(u.reshape(bsz, hh, ww, 3, 3, -1), 3, 3)
    if reduce:
        raw = reduce_from_model(raw, mesh)
    raw = raw.to(dt) + bias
    if h is not None and w.shape[2] > hid:
        raw = raw + plain_conv_apply(w[:, :, hid:, :], act(h.to(dt)), padding="SAME")
    return raw


def nice_net_raw_split_plain(params, z, h, mesh, act=F.elu):
    """``NICE2d._raw`` of a mesh rank's shard in plain PyTorch, for any
    activation and dtype: the first hidden a = act(conv3x3(z, w1)) whole
    (its gradient summed over the model axis), the rank's columns of the
    second, b = act(a @ w2), then ``_split_tail``.  Autograd through it
    gives the split backward."""
    from ..parallel.comm import copy_to_model

    a = copy_to_model(act(plain_conv_apply(params["w1"], z, padding="SAME")), mesh)
    b = act(conv1x1_dot(params["w2"], a))
    return _split_tail(params["out"], h, b, mesh, params["w1"].shape[-1], act)


class _NiceNetTrainSplit(torch.autograd.Function):
    """K4 at a mesh rank's shard: the forward is K4's launches at S = 2's N
    and S = 3's K of Hid/tp and the coupling's all-reduce; the backward is
    the four products on the shard,

        db = du @ wp_r^T,  dwp_r = b_r^T @ du  (through ``_split_tail``),
        dw2_r = a^T @ d(pre_b_r),  da = d(pre_b_r) @ w2_r^T (a partial sum),

    one all-reduce of da in fp32, then dw1 and dzcol, the same on every
    rank.  The out weight's hidden rows get their gradient summed over the
    model axis in ``_split_tail``'s backward."""

    @staticmethod
    def forward(ctx, z, h, w1, w2, v, g, b_out, mesh):
        params = {"w1": w1, "w2": w2, "out": {"v": v, "g": g, "b": b_out}}
        zcol, w1m, w2m, wp, w_eff = _operands(params, z, mesh)
        u, a, b = nice_net_train_u(zcol, w1m, w2m, wp)
        ctx.mesh = mesh
        ctx.save_for_backward(z, h, w1, w2, v, g, b_out, a, b)
        return _epilogue(u, w_eff, b_out, z, h, w1.shape[-1], mesh)

    @staticmethod
    def backward(ctx, grad):
        from ..parallel.comm import all_reduce_

        z, h, w1, w2, v, g, b_out, a, b = ctx.saved_tensors
        mesh = ctx.mesh
        dt = z.dtype
        hid, hs = w1.shape[-1], w2.shape[-1]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (v, g, b_out)]
            b4d = b.reshape(*z.shape[:3], hs).detach().requires_grad_()
            hd = None if h is None else h.detach().requires_grad_()
            out = dict(zip(("v", "g", "b"), leaves))
            inputs = leaves + [b4d] + ([] if hd is None else [hd])
            dv, dg, db_out, db4d, *dh = torch.autograd.grad(
                _split_tail(out, hd, b4d, mesh, hid, reduce=False), inputs, grad)
        db_pre = _elu_bwd(b, db4d.reshape(-1, hs))
        dw2 = _mm(a.t(), db_pre)
        da = all_reduce_(_mm32(db_pre, w2[0, 0].to(dt).t()), mesh.group("model"))
        da_pre = _elu_bwd(a, da.to(dt))
        zcol = im2col3x3(z)
        dw1 = _mm(zcol.t(), da_pre)
        dzcol = _mm(da_pre, w1.reshape(-1, hid).to(dt).t())
        with torch.enable_grad():
            zd = z.detach().requires_grad_()
            dz, = torch.autograd.grad(im2col3x3(zd), zd, dzcol)
        return (dz, dh[0] if dh else None, dw1.reshape(w1.shape).to(w1.dtype),
                dw2[None, None].to(w2.dtype), dv, dg, db_out, None)


def nice_net_raw_train_split(params, z, h, mesh):
    """``nice_net_raw_train`` on a mesh rank's shard: K4 forward at the
    shard's shapes, the split hand-written backward."""
    out = params["out"]
    return _NiceNetTrainSplit.apply(z, h, params["w1"], params["w2"], out["v"],
                                    out["g"], out["b"], mesh)
