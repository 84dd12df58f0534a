"""K3: SPADE GroupNorm + modulation in one CUDA kernel, a thread-block
cluster per frame (``csrc/spade_gn.cu``; replaces
``ipoke_tpu/ops/spade_gn.py::spade_gn_modulate_pallas``).

    out = GroupNorm(x) * (1 + gamma) + beta

x is (N, H, W, C) NHWC, one frame per n; gamma and beta are (BM, H, W, C)
with BM | N and are shared by the t = N / BM frames of a clip (frames are
B-major: frame n belongs to clip n // t).  Statistics are fp32 with the fast
variance max(E[x^2] - E[x]^2, 0); the normalised value is rounded to the IO
dtype before the modulation, which then runs in the IO dtype, as in
``ipoke_tpu/nn/blocks.py::_spade_gn_portable``.  ``spade_gn_plain`` is the
same function in plain PyTorch.

Each frame gets a cluster of k CTAs, each owning a contiguous 1/k of its
pixels (``spade_gn_plan``, by shape and dtype only): k is the smallest power
of two, at most 16, that makes a slice at most 128 KB.  The grid is
persistent: as many clusters as the card holds at once, each walking over
frames.  A slice that fits stays in the CTA's shared memory between the
statistics and the normalise pass, so x is read from device memory once,
and the next frame's slice streams in by bulk copies while this frame is
normalised; one that does not (k = 16 and still over 128 KB: fp32 frames
over 2 MiB, such as 128 px x 64 ch; or pixel rows that are not a multiple
of 16 bytes) is read twice, the second time mostly from L2.  At the decode
levels in bf16:

    level          frame     k    slice
    128 px x 64    2 MiB     16   128 KiB, resident
    64 px x 128    1 MiB      8   128 KiB, resident
    32 px x 256    512 KiB    4   128 KiB, resident
    16 px x 256    128 KiB    1   128 KiB, resident
"""

from __future__ import annotations

import torch

from . import LAUNCHES, _build

MAX_CLUSTER = 16             # CTAs per frame (non-portable beyond 8)
RESIDENT_BYTES = 128 * 1024  # the largest slice kept in shared memory


def spade_gn_plan(hw: int, c: int, itemsize: int):
    """(k, resident): K3's CTAs per frame of ``hw`` pixels of ``c`` channels
    of ``itemsize`` bytes, and whether each CTA's slice stays on chip (bulk
    copies move it, so its pixel rows must be a multiple of 16 bytes)."""
    k = 1
    while k < MAX_CLUSTER and k < hw and -(-hw // k) * c * itemsize > RESIDENT_BYTES:
        k *= 2
    return k, (-(-hw // k) * c * itemsize <= RESIDENT_BYTES
               and c * itemsize % 16 == 0)


def spade_gn_plain(x, gamma, beta, num_groups: int, eps: float = 1e-5):
    """Plain version: fp32 two-stage stats (per channel over H, W, then per
    group), fast variance, normalised value cast to x's dtype, then the
    per-clip modulation in x's dtype."""
    n, h, w, c = x.shape
    g = num_groups
    x32 = x.float()
    m_c = x32.mean(dim=(1, 2))
    m2_c = (x32 * x32).mean(dim=(1, 2))
    mu_g = m_c.reshape(n, g, c // g).mean(dim=2)
    m2_g = m2_c.reshape(n, g, c // g).mean(dim=2)
    s = torch.rsqrt(torch.clamp(m2_g - mu_g * mu_g, min=0.0) + eps)
    mu = mu_g.repeat_interleave(c // g, dim=1)[:, None, None, :]
    sc = s.repeat_interleave(c // g, dim=1)[:, None, None, :]
    normed = ((x32 - mu) * sc).to(x.dtype)
    bm = gamma.shape[0]
    if n % bm:
        raise ValueError(f"mod batch {bm} does not divide x batch {n}")
    t = n // bm
    out = normed.reshape(bm, t, h, w, c) * (1.0 + gamma[:, None]) + beta[:, None]
    return out.reshape(n, h, w, c)


def spade_gn_cuda(x, gamma, beta, num_groups: int, eps: float = 1e-5):
    """Launch K3 (one CUDA device, fp32 or bf16, at most 256 channels).
    The kernel alone has no backward: it raises while autograd records
    through an input that requires grad (``spade_gn_modulate`` gives it
    one)."""
    _build.refuse_grad("spade_gn", x, gamma, beta)
    n, h, w, c = x.shape
    bm = gamma.shape[0]
    if gamma.shape != beta.shape or tuple(gamma.shape[1:]) != (h, w, c):
        raise ValueError(f"spade_gn shapes: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    if n % bm or c % num_groups or c > 256:
        raise ValueError(f"spade_gn: {bm} clips must divide {n} frames and "
                         f"{num_groups} groups {c} channels (at most 256)")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or gamma.dtype != x.dtype or beta.dtype != x.dtype:
        raise TypeError("spade_gn kernel takes fp32 or bf16, one dtype")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("spade_gn inputs must lie on one device")
    # contiguous, aligned copies are held here until the launch is queued
    x, gamma, beta = (_build.aligned(t) for t in (x, gamma, beta))
    out = torch.empty_like(x)
    k, resident = spade_gn_plan(h * w, c, x.element_size())
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spade_gn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                           out.data_ptr(), n, h * w, c, num_groups, n // bm,
                           float(eps), int(x.dtype == torch.bfloat16), k,
                           int(resident), stream)
    _build.check(err, "spade_gn")
    LAUNCHES["spade_gn"] += 1
    return out


class SpadeGN(torch.autograd.Function):
    """``forward_fn`` (K3, ``spade_gn_cuda``, on the card) with the portable
    VJP as its backward, as the JAX package's ``spade_gn_fused``
    (``_fused_bwd``): autograd of ``spade_gn_plain`` recomputed from the
    saved inputs."""

    @staticmethod
    def forward(ctx, forward_fn, x, gamma, beta, num_groups, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.num_groups, ctx.eps = num_groups, eps
        return forward_fn(x, gamma, beta, num_groups, eps)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = spade_gn_plain(*inputs, ctx.num_groups, ctx.eps)
            dx, dgamma, dbeta = torch.autograd.grad(out, inputs, grad)
        return None, dx, dgamma, dbeta, None, None


def spade_gn_modulate(x, gamma, beta, num_groups: int, eps: float = 1e-5):
    """GroupNorm(x) * (1 + gamma) + beta with per-clip gamma/beta: K3 with
    the portable backward for CUDA tensors, the plain version for CPU
    tensors."""
    if x.is_cuda:
        return SpadeGN.apply(spade_gn_cuda, x, gamma, beta, num_groups, eps)
    if x.device.type != "cpu":
        raise ValueError(f"spade_gn: unsupported device {x.device}")
    return spade_gn_plain(x, gamma, beta, num_groups, eps)
