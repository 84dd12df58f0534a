"""K3: SPADE GroupNorm + modulation in one Triton kernel (replaces
``ipoke_tpu/ops/spade_gn.py::spade_gn_modulate_pallas``).

    out = GroupNorm(x) * (1 + gamma) + beta

x is (N, H, W, C) NHWC, one frame per n; gamma and beta are (BM, H, W, C)
with BM | N and are shared by the t = N / BM frames of a clip (frames are
B-major: frame n belongs to clip n // t).  Statistics are fp32 with the fast
variance max(E[x^2] - E[x]^2, 0); the normalised value is rounded to the IO
dtype before the modulation, which then runs in the IO dtype, as in
``ipoke_tpu/nn/blocks.py::_spade_gn_portable``.

Bound on the H100: a per-(frame, group) reduction followed by an elementwise
pass - no tensor-core work, memory bound.  Design: one program per (frame,
group) reads its group's NHWC slice twice, first for the fp32 sums and then
to normalise and modulate; the second read of at most 128 KB per program
(128^2 pixels x 4 channels in bf16) comes from L2, so x crosses device
memory about once, with gamma, beta and the output.  Its loads are narrow:
a group is CPG channels (8 bytes at the 128 px level) out of every 128-byte
pixel row, which keeps it far below the card's bandwidth; a program per
frame with full-row tiles is the next step.  ``spade_gn_plain`` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import os

import torch

from . import LAUNCHES, _build

tl = None  # triton.language, bound at the first launch (see _kernel)
_KERNEL = None


def _spade_gn_kernel(x_ptr, g_ptr, b_ptr, out_ptr, HW, C, CPG, G, T, eps,
                     BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    frame = (pid // G).to(tl.int64)
    grp = pid % G
    clip = frame // T
    x_base = frame * HW * C + grp * CPG
    m_base = clip * HW * C + grp * CPG
    offs_p = tl.arange(0, BLOCK_P)
    offs_c = tl.arange(0, BLOCK_C)
    cmask = offs_c < CPG

    acc = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
    acc2 = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
    for p0 in range(0, HW, BLOCK_P):
        p = p0 + offs_p
        mask = (p < HW)[:, None] & cmask[None, :]
        off = p[:, None] * C + offs_c[None, :]
        xv = tl.load(x_ptr + x_base + off, mask=mask, other=0.0).to(tl.float32)
        acc += xv
        acc2 += xv * xv
    cnt = HW * CPG * 1.0
    mean = tl.sum(tl.sum(acc, axis=1), axis=0) / cnt
    var = tl.maximum(tl.sum(tl.sum(acc2, axis=1), axis=0) / cnt - mean * mean, 0.0)
    rstd = 1.0 / tl.sqrt(var + eps)

    io = out_ptr.dtype.element_ty
    for p0 in range(0, HW, BLOCK_P):
        p = p0 + offs_p
        mask = (p < HW)[:, None] & cmask[None, :]
        off = p[:, None] * C + offs_c[None, :]
        xv = tl.load(x_ptr + x_base + off, mask=mask, other=0.0).to(tl.float32)
        gv = tl.load(g_ptr + m_base + off, mask=mask, other=0.0).to(tl.float32)
        bv = tl.load(b_ptr + m_base + off, mask=mask, other=0.0).to(tl.float32)
        # each op rounds to the IO dtype, as the plain version's ops do
        normed = ((xv - mean) * rstd).to(io).to(tl.float32)
        onep = (1.0 + gv).to(io).to(tl.float32)
        prod = (normed * onep).to(io).to(tl.float32)
        tl.store(out_ptr + x_base + off, (prod + bv).to(io), mask=mask)


def _kernel():
    """The jitted kernel; triton is imported here, at the first launch, so
    that this module imports where triton is missing.  Triton's compile
    cache goes beside the CUDA build, under ``build/`` in the checkout."""
    global tl, _KERNEL
    if _KERNEL is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        _KERNEL = triton.jit(_spade_gn_kernel)
    return _KERNEL


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
    """Launch the Triton kernel (one CUDA device, fp32 or bf16)."""
    n, h, w, c = x.shape
    bm = gamma.shape[0]
    if gamma.shape != beta.shape or tuple(gamma.shape[1:]) != (h, w, c):
        raise ValueError(f"spade_gn shapes: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    if n % bm or c % num_groups:
        raise ValueError(f"spade_gn: {bm} clips must divide {n} frames and "
                         f"{num_groups} groups {c} channels")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or gamma.dtype != x.dtype or beta.dtype != x.dtype:
        raise TypeError("spade_gn kernel takes fp32 or bf16, one dtype")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("spade_gn inputs must lie on one device")
    x, gamma, beta = x.contiguous(), gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    cpg = c // num_groups
    block_c = 1 << (cpg - 1).bit_length()
    block_p = max(16, 4096 // block_c)
    kernel = _kernel()
    with torch.cuda.device(x.device):
        kernel[(n * num_groups,)](x, gamma, beta, out, h * w, c, cpg,
                                  num_groups, n // bm, float(eps),
                                  BLOCK_P=block_p, BLOCK_C=block_c,
                                  num_warps=4)
    LAUNCHES["spade_gn"] += 1
    return out


def spade_gn_modulate(x, gamma, beta, num_groups: int, eps: float = 1e-5):
    """GroupNorm(x) * (1 + gamma) + beta with per-clip gamma/beta: the
    Triton kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return spade_gn_cuda(x, gamma, beta, num_groups, eps)
    if x.device.type != "cpu":
        raise ValueError(f"spade_gn: unsupported device {x.device}")
    return spade_gn_plain(x, gamma, beta, num_groups, eps)
