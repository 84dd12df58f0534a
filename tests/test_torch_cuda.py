"""The port's kernels against their plain versions on the card, at small and
ragged shapes the main path does not reach, and a toy sampling pass on the
card against the CPU port.  Needs a CUDA device (skips without one) and
imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ipoke_tpu_torch import entry, ops
from ipoke_tpu_torch.flows.base import Chain
from ipoke_tpu_torch.flows.macow import make_macow_unit
from ipoke_tpu_torch.ops import masked_conv, nice_net, spade_gn

pytestmark = pytest.mark.cuda

TOY = dict(spatial=32, min_spatial=8, T=3, z_dim=16, dec_ch=(32, 16, 8),
           nf_cond=8, num_steps=(2, 1), mid_factor=8, batch_size=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launches()
    return torch.device("cuda", 0)


def _randn(dev, *shape, std=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return std * torch.randn(shape, generator=g, device=dev)


# (M, C1, Hid, Cout): M not a multiple of the 128-row tile (100, 2577),
# K1 = 9·C1 not a multiple of the 64-deep K slice (45, 144, 270), Hid = 128
# and 384 (one and three 128-column tiles), N = 9·Cout (27, 36, 288: padded
# to 16 by the wrapper; 288 is above one wgmma's 256 and leaves a ragged
# last 64-column tile)
NICE_CASES = [(512, 16, 256, 32), (100, 5, 128, 3), (2560, 30, 2048, 4),
              (2577, 16, 384, 32), (100, 30, 128, 32)]


@pytest.mark.parametrize("m,c1,hid,cout", NICE_CASES)
def test_nice_net_kernel_matches_plain(dev, m, c1, hid, cout):
    """K1 at ragged row counts, with K1 and N padded to 16, and two calls
    bitwise equal (each u element is one dot product in a fixed order)."""
    zcol = _randn(dev, m, 9 * c1, seed=1).bfloat16()
    w1 = _randn(dev, 9 * c1, hid, std=(9 * c1) ** -0.5, seed=2).bfloat16()
    w2 = _randn(dev, hid, hid, std=hid ** -0.5, seed=3).bfloat16()
    wp = _randn(dev, hid, 9 * cout, std=(9 * hid) ** -0.5, seed=4).bfloat16()
    got = nice_net.nice_net_cuda(zcol, w1, w2, wp)
    want = nice_net.nice_net_plain(zcol, w1, w2, wp)
    assert got.shape == (m, 9 * cout) and ops.LAUNCHES["nice_net"] == 1
    torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2)
    assert torch.equal(got, nice_net.nice_net_cuda(zcol, w1, w2, wp))


@pytest.mark.parametrize("m,c1,hid,cout", NICE_CASES)
def test_nice_net_train_kernel_matches_plain(dev, m, c1, hid, cout):
    """K4 at ragged row counts (the last row block stores a part of a and
    b): u, a and b against the plain version, u bitwise K1's."""
    zcol = _randn(dev, m, 9 * c1, seed=1).bfloat16()
    w1 = _randn(dev, 9 * c1, hid, std=(9 * c1) ** -0.5, seed=2).bfloat16()
    w2 = _randn(dev, hid, hid, std=hid ** -0.5, seed=3).bfloat16()
    wp = _randn(dev, hid, 9 * cout, std=(9 * hid) ** -0.5, seed=4).bfloat16()
    got = nice_net.nice_net_train_cuda(zcol, w1, w2, wp)
    want = nice_net.nice_net_train_plain(zcol, w1, w2, wp)
    assert ops.LAUNCHES["nice_net_train"] == 1
    assert [tuple(t.shape) for t in got] == [(m, 9 * cout), (m, hid), (m, hid)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=5e-2, rtol=5e-2)
    assert torch.equal(got[0], nice_net.nice_net_cuda(zcol, w1, w2, wp))


def _unit_operands(dev, b, s, c, ch, g_std=0.3):
    """A packed unit (hid = 4C, kernel (2, 3)) with perturbed out convs (gains
    of std ``g_std``) and ActNorms, and its input y."""
    hid = 4 * c
    mcf = []
    for i in range(4):
        w_shift = _randn(dev, 2, 3, c, hid, std=(6 * c) ** -0.5, seed=10 + i)
        mcf.append({"w_shift": w_shift.transpose(0, 1) if i >= 2 else w_shift,
                    "out": {"v": _randn(dev, 1, 1, hid + ch, 2 * c, std=0.05, seed=20 + i),
                            "g": _randn(dev, 2 * c, std=g_std, seed=30 + i),
                            "b": _randn(dev, 2 * c, std=0.1, seed=40 + i)}})
    an = [{"log_scale": _randn(dev, c, std=0.05, seed=50 + i),
           "bias": _randn(dev, c, std=0.05, seed=60 + i)} for i in range(2)]
    y = _randn(dev, b, s, s, c, seed=70)
    h = _randn(dev, b, s, s, ch, seed=71) if ch else None
    return y, masked_conv.pack_unit(h, mcf, an, b, s, s)


# (B, H = W, C, Ch): batch 1, 3 and 40; C = 4, 18 (channels not a multiple of
# 4: padded float4 groups; hid 72: the last CTA of a cluster holds 12 hidden
# units) and 32; 8x8 and 16x16 (two column passes); with and without
# conditioning; and a 4x4 latent.  The first three draw the out convs'
# gains at std 0.3, the others at 0.1: at 0.3 an unconditioned B = 40 unit
# can diverge (the float64 plain inverse overflowed to 1e303 at 16x16, C =
# 4, and at 8x8, C = 18 rows reached 66, where the fp32 plain version sat
# 5.6e-4 from float64 and the kernel 2.0e-4, so no fp32 sum order meets
# 1e-4 there; tools/torch_k2_f64.py on an NVIDIA H100 80GB HBM3 at 700 W)
UNIT_CASES = [(3, 8, 8, 6), (2, 4, 4, 0), (40, 8, 32, 128),
              (1, 8, 4, 0), (3, 8, 18, 128), (40, 8, 4, 6), (1, 8, 32, 0),
              (40, 8, 18, 0), (3, 16, 32, 128), (1, 16, 18, 6), (40, 16, 4, 0),
              (40, 16, 32, 0), (3, 16, 4, 128),
              # the unconditioned units of config/flow_motion.yaml's bridge
              (32, 8, 32, 0), (32, 8, 28, 0)]


@pytest.mark.parametrize("b,s,c,ch", UNIT_CASES)
def test_unit_inverse_kernel_matches_plain(dev, b, s, c, ch):
    """K2 against its plain version, and two calls bitwise equal (every CTA
    of a cluster adds the partials in rank order)."""
    g_std = 0.3 if (b, s, c, ch) in UNIT_CASES[:3] else 0.1
    y, packed = _unit_operands(dev, b, s, c, ch, g_std)
    got = masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0)
    want = masked_conv.macow_unit_inverse_plain(y, *packed, 1.0)
    assert ops.LAUNCHES["macow_unit_inverse"] == 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0))


def test_unit_inverse_kernel_holds_noncontiguous_copies(dev):
    """A transposed view of hc and of w_hid: the wrapper launches on
    contiguous copies that it holds until the launch is queued, so the
    result is the one from contiguous inputs, bit for bit."""
    y, (w_shift, w_hid, hc, an_bias, an_inv) = _unit_operands(dev, 40, 8, 32, 128)
    hc_view = hc.transpose(2, 3).contiguous().transpose(2, 3)
    w_hid_view = w_hid.transpose(1, 2).contiguous().transpose(1, 2)
    assert not hc_view.is_contiguous() and not w_hid_view.is_contiguous()
    got = masked_conv.macow_unit_inverse_cuda(y, w_shift, w_hid_view, hc_view,
                                              an_bias, an_inv, 1.0)
    want = masked_conv.macow_unit_inverse_plain(y, w_shift, w_hid, hc, an_bias,
                                                an_inv, 1.0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, masked_conv.macow_unit_inverse_cuda(
        y, w_shift, w_hid, hc, an_bias, an_inv, 1.0))


def test_unit_inverse_footprint_matches_kernel(dev):
    """``k2_smem_bytes`` (which ``unit_fits`` uses) against the kernel's own
    count at every SHIPPED level, 8x8 and 16x16, and the kernel refuses
    what ``unit_fits`` refuses for a reason other than the footprint."""
    from ipoke_tpu_torch.ops import _build

    lib = _build.load()
    for c in range(32, 2, -2):
        for s in (8, 16):
            assert lib.macow_unit_inverse_smem_bytes(s, s, c, 4 * c, 2, 3) == \
                masked_conv.k2_smem_bytes(s, s, c, 4 * c, 2, 3), (s, c)
    for shape, hid, ks in (((1, 8, 16, 8), 32, (2, 3)), ((1, 8, 8, 8), 30, (2, 3)),
                           ((1, 8, 8, 8), 32, (2, 5)), ((1, 8, 8, 34), 136, (2, 3))):
        assert not masked_conv.unit_fits(shape, hid, ks)
        assert lib.macow_unit_inverse_smem_bytes(*shape[1:], hid, *ks) == -1


def _mcf_params(dev, c, hid, ch, ks, seed):
    """One masked-conv flow with a non-trivial out conv (g/b set directly)."""
    return {"w_shift": _randn(dev, *ks, c, hid, std=(ks[0] * ks[1] * c) ** -0.5,
                              seed=seed),
            "out": {"v": _randn(dev, 1, 1, hid + ch, 2 * c, std=0.05, seed=seed + 1),
                    "g": _randn(dev, 2 * c, std=0.3, seed=seed + 2),
                    "b": _randn(dev, 2 * c, std=0.1, seed=seed + 3)}}


# K5 cases: W = 7 and 13 (not a multiple of the 8 columns of a tap-dot
# pass), C = 4 and 8 (clusters of 1), C = 16 (clusters of 2), C = 18
# (clusters of 4 whose last CTA holds 12 of the 72 hidden units; channels
# padded to float4 groups) and 32 (clusters of 4), non-square latents in
# both orientations, with and without conditioning rows, and a 32x32x32
# latent that K2 cannot hold
K5_CASES = [(3, 5, 7, 8, 6, "A"), (2, 8, 8, 4, 0, "B"), (2, 6, 13, 8, 0, "C"),
            (3, 8, 16, 32, 128, "D"), (40, 32, 32, 32, 128, "A"),
            (3, 8, 16, 16, 6, "B"), (2, 16, 8, 18, 128, "C")]


@pytest.mark.parametrize("b,hh,ww,c,ch,order", K5_CASES)
def test_masked_conv_inverse_kernel_matches_plain(dev, b, hh, ww, c, ch, order):
    """K5 through its dispatcher against the plain row scan, and two calls
    bitwise equal (every CTA of a cluster adds the partials in rank
    order)."""
    ks = (2, 3) if order in ("A", "B") else (3, 2)  # C/D store them swapped
    params = _mcf_params(dev, c, 4 * c, ch, ks, 100)
    y = _randn(dev, b, hh, ww, c, seed=110)
    h = _randn(dev, b, hh, ww, ch, seed=111) if ch else None
    got = masked_conv.masked_conv_inverse(y, h, params, order)
    want = masked_conv.scan_inverse(
        masked_conv.masked_conv_inverse_plain, y,
        None if h is None else F.elu(h), params, order, 1.0)
    assert ops.LAUNCHES["masked_conv_inverse"] == 1 and got.shape == y.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, masked_conv.masked_conv_inverse(y, h, params, order))


# K5's wide path (tap weights streamed from shared memory): the `reshape:
# down` stack's 4x4 flows (C = 128 / 96 / 64, hid 256 / 384 / 256: more than
# 16 tap groups, and at hid 384 48 hidden units a CTA in passes of 32), and
# C = 34 (channels padded to float4 groups, 18 tap groups) at 8x8
K5_WIDE_CASES = [(3, 4, 4, 128, 256, 8, "A"), (2, 4, 4, 96, 384, 0, "D"),
                 (2, 4, 4, 64, 256, 8, "B"), (2, 8, 8, 34, 136, 6, "C")]


@pytest.mark.parametrize("b,hh,ww,c,hid,ch,order", K5_WIDE_CASES)
def test_masked_conv_inverse_wide_matches_plain(dev, b, hh, ww, c, hid, ch, order):
    """K5's wide path through its dispatcher against the plain row scan,
    and two calls bitwise equal."""
    ks = (2, 3) if order in ("A", "B") else (3, 2)
    assert not masked_conv.k5_registers(c, hid, 2)
    params = _mcf_params(dev, c, hid, ch, ks, 120)
    y = _randn(dev, b, hh, ww, c, seed=130)
    h = _randn(dev, b, hh, ww, ch, seed=131) if ch else None
    got = masked_conv.masked_conv_inverse(y, h, params, order)
    want = masked_conv.scan_inverse(
        masked_conv.masked_conv_inverse_plain, y,
        None if h is None else F.elu(h), params, order, 1.0)
    assert ops.LAUNCHES["masked_conv_inverse"] == 1 and got.shape == y.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, masked_conv.masked_conv_inverse(y, h, params, order))


# K5's streamed instance (fault (e)): past shared memory (2x2x512 at hid
# 512, 4x4x256 at hid 2048) and rows over 1024 elements (16x16x128), its
# row staged in shared memory; and a 2x64x512 row too wide to stage
K5_STREAMED_CASES = [(2, 2, 2, 512, 512, 8, "B"), (2, 4, 4, 256, 2048, 0, "A"),
                     (2, 16, 16, 128, 256, 8, "C"), (2, 2, 64, 512, 512, 0, "A")]


@pytest.mark.parametrize("b,hh,ww,c,hid,ch,order", K5_STREAMED_CASES)
def test_masked_conv_inverse_streamed_matches_plain(dev, b, hh, ww, c, hid, ch, order):
    """K5's streamed instance through its dispatcher against the plain row
    scan, and two calls bitwise equal."""
    ks = (2, 3) if order in ("A", "B") else (3, 2)
    assert masked_conv.k5_streamed(ww if order in "AB" else hh, c, hid, 2, 3,
                                   masked_conv.k5_cluster(hid))
    params = _mcf_params(dev, c, hid, ch, ks, 140)
    y = _randn(dev, b, hh, ww, c, seed=150)
    h = _randn(dev, b, hh, ww, ch, seed=151) if ch else None
    got = masked_conv.masked_conv_inverse(y, h, params, order)
    want = masked_conv.scan_inverse(
        masked_conv.masked_conv_inverse_plain, y,
        None if h is None else F.elu(h), params, order, 1.0)
    assert ops.LAUNCHES["masked_conv_inverse"] == 1 and got.shape == y.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got, masked_conv.masked_conv_inverse(y, h, params, order))


def test_masked_conv_inverse_footprint_matches_kernel(dev):
    """``k5_smem_bytes`` and ``k5_streamed`` against the kernel's own count
    and choice at every SHIPPED level's width and cluster, rows of 8, 16
    and 32 columns, the wide path's and the streamed instance's shapes, and
    the kernel refuses what ``k5_fits`` refuses."""
    from ipoke_tpu_torch.ops import _build

    lib = _build.load()
    for c in range(32, 2, -2):
        k = masked_conv.k5_cluster(4 * c)
        for w in (8, 16, 32):
            assert lib.masked_conv_inverse_smem_bytes(w, c, 4 * c, 2, 3, k) == \
                masked_conv.k5_smem_bytes(w, c, 4 * c, 2, 3, k), (w, c)
    for c, hid in ((128, 256), (96, 384), (64, 256), (34, 136)):  # the wide path
        k = masked_conv.k5_cluster(hid)
        assert lib.masked_conv_inverse_smem_bytes(4, c, hid, 2, 3, k) == \
            masked_conv.k5_smem_bytes(4, c, hid, 2, 3, k), (c, hid)
    for w, c, hid in ((33, 32, 128), (2, 512, 512), (4, 256, 2048), (16, 128, 256),
                      (64, 512, 512)):
        k = masked_conv.k5_cluster(hid)
        assert masked_conv.k5_streamed(w, c, hid, 2, 3, k)
        assert lib.masked_conv_inverse_streamed_at(w, c, hid, 2, 3, k) == 1
        assert lib.masked_conv_inverse_smem_bytes(w, c, hid, 2, 3, k) == \
            masked_conv.k5_smem_bytes(w, c, hid, 2, 3, k), (w, c, hid)
    assert lib.masked_conv_inverse_streamed_at(16, 32, 128, 2, 3, 4) == 0
    for shape, hid, ks in (((1, 8, 8, 8), 30, (2, 3)), ((1, 8, 8, 8), 32, (2, 5))):
        assert not masked_conv.k5_fits(shape, hid, ks)
        assert lib.masked_conv_inverse_smem_bytes(
            shape[2], shape[3], hid, *ks, masked_conv.k5_cluster(hid)) == -1


def test_unit_inverse_k2_matches_per_flow_route(dev):
    """The level-0 SHIPPED unit (C=32, hid 128, 128 conditioning channels,
    8x8) with perturbed out convs and ActNorms: K2 in one launch against the
    chain inverse, four K5 launches and two ActNorm inverses.  Two
    independent kernels for the same four recurrences."""
    unit = make_macow_unit(32, (2, 3), h_channels=128)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = unit.init(gen, dev)
    for p in params:
        if "out" in p:
            p["out"]["g"] = 0.3 * torch.randn(64, generator=gen, device=dev)
            p["out"]["b"] = 0.1 * torch.randn(64, generator=gen, device=dev)
        else:
            p["log_scale"] = 0.05 * torch.randn(32, generator=gen, device=dev)
            p["bias"] = 0.05 * torch.randn(32, generator=gen, device=dev)
    y = _randn(dev, 40, 8, 8, 32, seed=120)
    h = _randn(dev, 40, 8, 8, 128, seed=121)
    k2 = unit.inverse(params, y, h)
    assert ops.LAUNCHES["macow_unit_inverse"] == 1
    per_flow = Chain.inverse(unit, params, y, h)
    assert ops.LAUNCHES["masked_conv_inverse"] == 4
    torch.testing.assert_close(k2, per_flow, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,clips", [((6, 8, 8, 32), 2), ((4, 5, 5, 48), 4),
                                         ((3, 16, 16, 64), 1)])
def test_spade_gn_kernel_matches_plain(dev, shape, clips, dtype, tol):
    """K3 in fp32 and bf16, with 3 channels per group (a masked block) and
    with one frame per clip."""
    x = (2.0 * _randn(dev, *shape, seed=80) + 0.5).to(dtype)
    gamma = _randn(dev, clips, *shape[1:], std=0.5, seed=81).to(dtype)
    beta = _randn(dev, clips, *shape[1:], std=0.5, seed=82).to(dtype)
    got = spade_gn.spade_gn_cuda(x, gamma, beta, 16)
    want = spade_gn.spade_gn_plain(x, gamma, beta, 16)
    assert got.dtype == dtype and ops.LAUNCHES["spade_gn"] == 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, spade_gn.spade_gn_cuda(x, gamma, beta, 16))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
def test_spade_gn_kernel_gradients_match_plain(dev, dtype, tol):
    """Autograd through K3 (``spade_gn_modulate`` on the card: the kernel
    forward, the portable VJP backward) against autograd of the plain
    version: the gradients of x, gamma and beta, in fp32 and bf16."""
    x = (2.0 * _randn(dev, 6, 8, 8, 32, seed=86) + 0.5).to(dtype)
    gamma = _randn(dev, 2, 8, 8, 32, std=0.5, seed=87).to(dtype)
    beta = _randn(dev, 2, 8, 8, 32, std=0.5, seed=88).to(dtype)
    r = _randn(dev, 6, 8, 8, 32, seed=89)
    grads = []
    for fn in (spade_gn.spade_gn_modulate, spade_gn.spade_gn_plain):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        loss = (fn(*leaves, 16).float() * r).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    assert ops.LAUNCHES["spade_gn"] == 1
    for got, want in zip(*grads):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernels_without_backward_refuse_grad(dev):
    """K1 (inference), K2 and K5 have no backward, as in the JAX package:
    each raises while autograd records through an input that requires
    grad, launches nothing, and runs under ``no_grad``."""
    zcol = _randn(dev, 64, 36, seed=1).bfloat16()
    w1 = _randn(dev, 36, 128, std=36 ** -0.5, seed=2).bfloat16()
    w2 = _randn(dev, 128, 128, std=128 ** -0.5, seed=3).bfloat16()
    wp = _randn(dev, 128, 18, std=128 ** -0.5, seed=4).bfloat16()
    y, packed = _unit_operands(dev, 2, 8, 8, 0)
    ys = _randn(dev, 2, 8, 16, 8, seed=5)
    w_shift = _randn(dev, 2, 3, 8, 32, std=48 ** -0.5, seed=6)
    w_hid = _randn(dev, 32, 16, std=0.05, seed=7)
    hc = _randn(dev, 2, 8, 16, 16, std=0.1, seed=8)
    calls = {
        "nice_net": (nice_net.nice_net_cuda, (zcol, w1, w2, wp)),
        "macow_unit_inverse": (masked_conv.macow_unit_inverse_cuda, (y, *packed, 1.0)),
        "masked_conv_inverse": (masked_conv.masked_conv_inverse_cuda,
                                (ys, w_shift, w_hid, hc, 1.0, False)),
    }
    for name, (fn, args) in calls.items():
        for i, t in enumerate(args):
            if not isinstance(t, torch.Tensor):
                continue
            leaf = list(args)
            leaf[i] = t.clone().requires_grad_()
            with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
                fn(*leaf)
        assert ops.LAUNCHES[name] == 0
        with torch.no_grad():
            fn(*leaf)
        assert ops.LAUNCHES[name] == 1


# (shape, clips, groups): the four decode levels at a few frames (k = 16, 8,
# 4 and 1 in bf16; fp32 at 128 px streams its slices), one clip and one clip
# per frame; 45x45 and 33x33 frames, whose pixels do not split evenly over
# the cluster; 3, 4, 8 and 16 channels per group; and 20 channels, whose
# pixel rows are not a multiple of 16 bytes (element by element, streamed)
SPADE_LEVELS = [((4, 128, 128, 64), 1, 16), ((4, 64, 64, 128), 4, 16),
                ((2, 32, 32, 256), 1, 16), ((4, 16, 16, 256), 2, 16),
                ((2, 45, 45, 64), 2, 16), ((3, 33, 33, 48), 3, 16),
                ((4, 9, 9, 20), 2, 4)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,clips,groups", SPADE_LEVELS)
def test_spade_gn_kernel_levels_match_plain(dev, shape, clips, groups, dtype, tol):
    """K3 at the decode levels and ragged shapes, in fp32 and bf16, and two
    calls bitwise equal (each CTA adds its cluster's partials in rank
    order)."""
    x = (2.0 * _randn(dev, *shape, seed=83) + 0.5).to(dtype)
    gamma = _randn(dev, clips, *shape[1:], std=0.5, seed=84).to(dtype)
    beta = _randn(dev, clips, *shape[1:], std=0.5, seed=85).to(dtype)
    got = spade_gn.spade_gn_cuda(x, gamma, beta, groups)
    want = spade_gn.spade_gn_plain(x, gamma, beta, groups)
    assert got.dtype == dtype and ops.LAUNCHES["spade_gn"] == 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, spade_gn.spade_gn_cuda(x, gamma, beta, groups))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    z = torch.zeros(64, 9 * 4, device=dev)
    w = torch.zeros(9 * 4, 128, device=dev)
    with pytest.raises(TypeError):  # fp32 operands
        nice_net.nice_net_u(z, w, torch.zeros(128, 128, device=dev),
                            torch.zeros(128, 18, device=dev))
    x = torch.zeros(4, 8, 8, 32, device=dev)
    with pytest.raises(ValueError):  # 3 clips do not divide 4 frames
        spade_gn.spade_gn_modulate(x, x[:3], x[:3], 16)
    wide = torch.zeros(2, 4, 4, 272, device=dev)  # over K3's 256 channels
    with pytest.raises(ValueError, match="at most 256"):
        spade_gn.spade_gn_modulate(wide, wide[:1], wide[:1], 16)
    # K2: a latent it does not take (not square) raises, naming the shape
    y, packed = _unit_operands(dev, 2, 8, 8, 0)
    y816 = torch.zeros(2, 8, 16, 8, device=dev)
    hc816 = torch.zeros(4, 2, 8, 16, 16, device=dev)
    with pytest.raises(ValueError, match=r"\(2, 8, 16, 8\).*unit_fits"):
        masked_conv.macow_unit_inverse_cuda(y816, packed[0], packed[1], hc816,
                                            *packed[3:], 1.0)
    # K5: fp32 only, one device, a footprint within the opt-in limit
    y = torch.zeros(2, 8, 16, 32, device=dev)
    packed = (torch.zeros(2, 3, 32, 128, device=dev),
              torch.zeros(128, 64, device=dev), torch.zeros(2, 8, 16, 64, device=dev))
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError):
            masked_conv.masked_conv_inverse_cuda(
                y.to(dtype), *(t.to(dtype) for t in packed), 1.0, False)
    with pytest.raises(ValueError, match="one device"):
        masked_conv.masked_conv_inverse_cuda(y, packed[0].cpu(), *packed[1:], 1.0, False)
    wide = torch.zeros(2, 2, 256, 32, device=dev)  # one ring row of 258 columns
    with pytest.raises(ValueError, match=r"\(2, 2, 256, 32\).*shared"):
        masked_conv.masked_conv_inverse_cuda(
            wide, packed[0], packed[1], torch.zeros(2, 2, 256, 64, device=dev),
            1.0, False)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


@pytest.mark.parametrize("dtype,kernels,tol", [
    (torch.float32, ("macow_unit_inverse", "spade_gn"), 1e-3),
    (torch.bfloat16, ("nice_net", "macow_unit_inverse", "spade_gn"), 0.25),
])
def test_toy_sampling_card_matches_cpu(dev, dtype, kernels, tol):
    """A toy forward_sample on the card (kernels) against the CPU port
    (plain versions), same weights and z.  K1's family is bf16 only; the bf16
    bound is chip_smoke.py's (bf16 noise through the inverse)."""
    gen = torch.Generator().manual_seed(0)
    model = entry.build(TOY, "cpu", gen)
    entry.perturb(model.flow_params, gen, 0.03, 0.03)
    model = model.to(dtype)
    batch = entry.make_batch(TOY, "cpu", dtype)
    z = torch.randn((2, 8, 8, TOY["z_dim"]), generator=gen).to(dtype)
    want = model.forward_sample(batch, TOY["T"], z=z)
    ops.reset_launches()
    got = copy.deepcopy(model).to(dev).forward_sample(
        {k: v.to(dev) for k, v in batch.items()}, TOY["T"], z=z.to(dev))
    assert all(ops.LAUNCHES[k] > 0 for k in kernels), ops.LAUNCHES
    diff = (got.cpu().float() - want.float()).abs()
    assert np.isfinite(diff.numpy()).all() and diff.max().item() <= tol, \
        diff.max().item()


@pytest.mark.parametrize("product,m,k,n,x_t", [
    ("dW2 = a^T db_pre", 2048, 2560, 2048, True),
    ("da = db_pre w2^T", 2560, 2048, 2048, False),
    ("dW1 = zcol^T da_pre", 144, 2560, 2048, True),
    ("dzcol = da_pre w1^T", 2560, 2048, 144, False)])
def test_k4_backward_products_sum_in_fp32(dev, product, m, k, n, x_t):
    """K4's backward products at the level-0 shapes (``_mm``, operands laid
    out as the backward passes them) against the same bf16 operands summed
    in fp64 and rounded once to bf16.  The two halves of each sum cancel to
    ~1/70 of either: a partial sum rounded to bf16 (cuBLAS split-K under a
    bf16 output) errs by ~10% of the result, fp32 sums by ~1e-4 absolute."""
    x = (1.0 + 0.01 * _randn(dev, m, k, seed=90)).bfloat16()
    if x_t:
        x = x.t().contiguous().t()
    r = _randn(dev, k // 2, n, seed=91)
    y = torch.cat([r, -r + 0.01 * _randn(dev, k // 2, n, seed=92)]).bfloat16()
    got = nice_net._mm(x, y)
    want = (x.double() @ y.double()).bfloat16()
    assert got.dtype == torch.bfloat16, product
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2 ** -7)


def test_toy_train_step_card_matches_cpu(dev):
    """Three bf16 train steps with fp32 masters at a constant lr on the card
    (K1 in the remat's no-grad pass, K4 in the recompute and the priors)
    against the CPU port, from the same post-DDI weights: the launches of
    every card step, and the three losses, the second and third of which
    follow the first update and so hold K4's backward on the card against
    the CPU's; chip_smoke.py's bound for SMALL."""
    from ipoke_tpu_torch.train import SecondStageTrainer

    cfg = dict(TOY, min_spatial=4, enc_ch=(16, 16, 32, 32), dec_ch=(32, 32, 16, 16))
    gen = torch.Generator().manual_seed(0)
    model = entry.build(cfg, "cpu", gen)
    batch = entry.make_batch(cfg, "cpu")
    SecondStageTrainer(model, 1e-3).ddi(batch)
    entry.perturb(model.flow_params, gen, 0.03, 0.03)
    steps = sum(cfg["num_steps"])
    losses = []
    for m, d in ((copy.deepcopy(model).to(dev), dev), (model, "cpu")):
        trainer = SecondStageTrainer(m, 1e-3)
        trainer.start()
        b = {k: v.to(d) for k, v in batch.items()}
        losses.append([])
        for _ in range(3):
            ops.reset_launches()
            losses[-1].append(trainer.train_step(b)["flow_loss"].item())
            if d == dev:
                assert ops.LAUNCHES["nice_net"] == 4 * steps
                assert ops.LAUNCHES["nice_net_train"] == 4 * steps + len(cfg["num_steps"])
    card, cpu = np.array(losses)
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=5e-2)


# the first-stage decoder's training shapes (S, Ch): fp32, 20 frames rendered
# one at a time, so one modulation per frame
SPADE_TRAIN = [(16, 256), (32, 128), (64, 64)]


@pytest.mark.parametrize("s,ch", SPADE_TRAIN)
def test_spade_gn_kernel_training_shapes(dev, s, ch):
    """K3 at the first-stage training shapes, fp32, t = 1: the forward
    against the plain version and bitwise repeated; the gradients through
    K3 + the portable VJP equal to autograd of the plain version (the same
    backward on the same inputs)."""
    x = 2.0 * _randn(dev, 20, s, s, ch, seed=90) + 0.5
    gamma = _randn(dev, 20, s, s, ch, std=0.5, seed=91)
    beta = _randn(dev, 20, s, s, ch, std=0.5, seed=92)
    r = _randn(dev, 20, s, s, ch, seed=93)
    got = spade_gn.spade_gn_cuda(x, gamma, beta, 16)
    torch.testing.assert_close(got, spade_gn.spade_gn_plain(x, gamma, beta, 16),
                               atol=2e-5, rtol=2e-5)
    assert torch.equal(got, spade_gn.spade_gn_cuda(x, gamma, beta, 16))
    assert spade_gn.spade_gn_plan(s * s, ch, 4)[1]  # the slices stay on chip
    grads = []
    for fn in (spade_gn.spade_gn_modulate, spade_gn.spade_gn_plain):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        grads.append(torch.autograd.grad((fn(*leaves, 16) * r).sum(), leaves))
    assert ops.LAUNCHES["spade_gn"] == 3
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s,ch", SPADE_TRAIN)
def test_spade_gn_bf16_training_shapes_card_matches_cpu(dev, s, ch):
    """K3 in bf16 under autograd at the first-stage training shapes (the
    ``mixed_prec`` decoder's): the card's forward against the CPU's plain
    version within chip_smoke.py's bf16 bound (3e-2 abs + rel), the
    gradients through K3 + the portable VJP in bf16 and against the CPU's
    autograd of the plain version within the same bound."""
    x = (2.0 * _randn(dev, 20, s, s, ch, seed=94) + 0.5).bfloat16()
    gamma = _randn(dev, 20, s, s, ch, std=0.5, seed=95).bfloat16()
    beta = _randn(dev, 20, s, s, ch, std=0.5, seed=96).bfloat16()
    r = _randn(dev, 20, s, s, ch, seed=97).bfloat16()
    out = []
    for d in (dev, "cpu"):
        leaves = [t.to(d).clone().requires_grad_() for t in (x, gamma, beta)]
        y = spade_gn.spade_gn_modulate(*leaves, 16)
        out.append((y, *torch.autograd.grad((y * r.to(d)).sum(), leaves)))
    assert ops.LAUNCHES["spade_gn"] == 1
    for a, b in zip(*out):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("rule", ["use_adafactor", "use_adabelief"])
def test_rule_steps_card_match_cpu(dev, rule):
    """Three fp32 train steps under Adafactor / AdaBelief on the card (no
    kernel: K1 and K4 are bf16 only) against the CPU port from the same
    post-DDI weights: the losses within 1e-3 relative, every state tensor
    within 2e-3 of its norm (chip_smoke.py's (p2) rule)."""
    from ipoke_tpu_torch.train import SecondStageTrainer

    cfg = dict(TOY, min_spatial=4, enc_ch=(16, 16, 32, 32), dec_ch=(32, 32, 16, 16))
    gen = torch.Generator().manual_seed(0)
    model = entry.build(cfg, "cpu", gen)
    model.config["training"]["mixed_prec_master"] = False
    batch = entry.make_batch(cfg, "cpu")
    SecondStageTrainer(model, 1e-3).ddi(batch)
    entry.perturb(model.flow_params, gen, 0.03, 0.03)
    losses, states = [], []
    for m, d in ((copy.deepcopy(model).to(dev), dev), (model, "cpu")):
        m.config["training"][rule] = True
        trainer = SecondStageTrainer(m, 1e-3)
        trainer.start()
        b = {k: v.to(d) for k, v in batch.items()}
        ops.reset_launches()
        losses.append([trainer.train_step(b)["flow_loss"].item() for _ in range(3)])
        assert not any(ops.LAUNCHES.values())
        states.append(trainer.tx.state_dict())
    np.testing.assert_allclose(*losses, rtol=1e-3)
    card, cpu = states
    assert card["count"] == cpu["count"] == 3
    for key in cpu:
        if key == "count":
            continue
        for a, b in zip(card[key], cpu[key]):
            if b is not None:
                assert (a.cpu() - b).norm() <= 2e-3 * b.norm() + 1e-30, key


def _check_update(card_tx, cpu_tx, lr, name):
    """The card's optimizer after an update against the CPU's, by
    chip_smoke.py's (i2) rule: every param within 2 lr, at most 1% of them
    more than lr / 10 apart; Adam's first moments by leaf norm within 3e-4
    plus, per entry, 1e-4 of the RMS entry of the CPU's moments."""
    d = [(p.detach().cpu() - q.detach()).abs()
         for p, q in zip(card_tx.params, cpu_tx.params)]
    assert max(x.max() for x in d) <= 2 * lr, name
    assert sum(int((x > 0.1 * lr).sum()) for x in d) <= 0.01 * sum(x.numel() for x in d), name
    mus = [cpu_tx.adam.state[q]["exp_avg"] for q in cpu_tx.params]
    floor = 1e-4 * torch.cat([m.flatten() for m in mus]).square().mean().sqrt()
    for j, (p, m) in enumerate(zip(card_tx.params, mus)):
        g = card_tx.adam.state[p]["exp_avg"].cpu()
        assert (g - m).norm() <= 3e-4 * m.norm() + floor * m.numel() ** 0.5, (name, j)


def test_first_stage_tiny_step_card_matches_cpu(dev):
    """One first-stage TINY step on the card (K3 in the decoder's training
    graph, cuDNN convs, the gradient penalty's double backward) against the
    CPU port from the same weights and draws, TF32 off, 18 K3 launches:

    * every metric within 1e-3 of 1 + |CPU| (chip_smoke.py's (i2) bound);
    * gradients, as Adam's first moments, by leaf norm within 3e-4 plus, per
      entry, 1e-4 of the RMS entry of the net's moments (the rule of the
      test against the jitted JAX step): Adam's first step moves each entry
      by about lr whatever its gradient, so the params alone would pass a
      gradient of the wrong sign;
    * params: every entry within 2 lr, at most 1% of a net's entries more
      than lr / 10 apart.

    On the CPU, fp32 against float64 holds the same rule
    (``test_step_fp32_holds_card_rule_against_float64``)."""
    from ipoke_tpu_torch.core.optim import gan_adam
    from ipoke_tpu_torch.models import first_stage as fs

    lr = 1e-3
    cfg = entry.FIRST_STAGE_TINY
    nets = entry.build_first_stage(cfg, "cpu", torch.Generator().manual_seed(0))
    images = entry.make_first_stage_batch(cfg, "cpu")["images"]
    draws = fs.sample_draws(torch.Generator().manual_seed(1), cfg, 2)
    out = []
    for d in (dev, "cpu"):
        ns = [copy.deepcopy(n).to(d) for n in nets]
        txs = fs.create_first_stage_state(*ns[:3], lambda p: gan_adam(p, lr))
        step = fs.FirstStageStep(cfg, *ns, *txs)
        ops.reset_launches()
        metrics = step({"images": images.to(d)},
                       {k: v.to(d) if torch.is_tensor(v) else v
                        for k, v in draws.items()}, 1.0)
        if d == dev:
            assert ops.LAUNCHES["spade_gn"] == 18
        out.append(({k: v.item() for k, v in metrics.items()}, txs))
    (card, card_txs), (cpu, cpu_txs) = out
    for k in cpu:
        assert abs(card[k] - cpu[k]) <= 1e-3 * (1 + abs(cpu[k])), k
    for i, (ta, tb) in enumerate(zip(card_txs, cpu_txs)):
        _check_update(ta, tb, lr, i)


def test_flow_motion_tiny_card_matches_cpu(dev):
    """FLOW_MOTION_TINY on the card against the CPU port, fp32, the same
    weights (the bridge's and the cINN's couplings perturbed at 0.1) and
    noise: hallucinated flow (4 unconditioned K2 launches) within
    chip_smoke.py's 1e-3 abs + rel, and one bridge step (no kernel): its
    metrics within 1e-3 of 1 + |CPU|, its params and Adam's first moments
    by ``_check_update``."""
    from ipoke_tpu_torch.train import FlowMotionTrainer

    cfg = entry.FLOW_MOTION_TINY
    ss = cfg["second_stage"]
    gen = torch.Generator().manual_seed(0)
    cpu = entry.build_flow_motion(cfg, "cpu", gen)
    entry.perturb(cpu.second_stage.flow_params, gen, 0.1, 0.1)
    entry.perturb(cpu.inn_params, gen, 0.1, 0.1)
    card = copy.deepcopy(cpu).to(dev)
    batch = entry.make_batch(ss, "cpu")
    on_card = {k: v.to(dev) for k, v in batch.items()}
    shape = lambda c: (ss["batch_size"], ss["min_spatial"], ss["min_spatial"], c)
    z = torch.randn(shape(cpu.z_total), generator=gen)
    got = card.forward_sample_flow(on_card, z=z.to(dev))
    assert ops.LAUNCHES["macow_unit_inverse"] == 4 * sum(cfg["architecture"]["num_steps"])
    torch.testing.assert_close(got.cpu(), cpu.forward_sample_flow(batch, z=z),
                               atol=1e-3, rtol=1e-3)
    noise = tuple(torch.randn(shape(c), generator=gen)
                  for c in (cpu.z_flow, cpu.z_total - cpu.z_flow, cpu.z_total))
    ops.reset_launches()
    trainers = [FlowMotionTrainer(m, 1e-3) for m in (card, cpu)]
    got = trainers[0].train_step(on_card, 0, noise=tuple(t.to(dev) for t in noise))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}
    want = trainers[1].train_step(batch, 0, noise=noise)
    for k in want:
        assert abs(got[k].item() - want[k].item()) <= 1e-3 * (1 + abs(want[k].item())), k
    _check_update(*(t.state.tx for t in trainers), 1e-3, "bridge")


def test_second_stage_experiment_card_matches_cpu(dev, tmp_path):
    """The TINY ``second_stage`` experiment (``tests/test_second_stage.py``'s
    SS_CFG with a NICE hidden width of 128, so that K1 and K4 take its
    couplings, in bf16 with fp32 masters, over TINY frozen stages trained on
    the CPU, the first stage deterministic) runs one epoch of 2 batches through
    ``ipoke_tpu_torch.main`` on the card and on the CPU, from the same seed
    (the weights are drawn on the CPU) and the same synthetic tree.  The
    logged step-1 losses are held by phase (f)'s rule, 5e-2 relative (the
    ``reference_nll_loss`` diagnostic is a fresh draw of each device's
    generator and is not compared); then ``--resume`` on the card continues
    the step and the optimizer's count without a second DDI."""
    import json

    from test_torch_cli import CONFIGS, SS, Env

    env = Env(tmp_path)
    for exp in ("img_encoder", "poke_encoder", "first_stage"):
        body = copy.deepcopy(CONFIGS[exp])
        body["architecture"]["deterministic"] = True
        env.run(env.config(exp, body))
    ss = copy.deepcopy(SS)  # NICE hidden 16 * 8 = 128: K1/K4's family
    ss["architecture"]["flow_mid_channels_factor"] = 16
    path = env.config("second_stage", ss)
    runs = [env.run(path, device=d) for d in ("cpu", "cuda")]

    def step1(e):
        with open(e.metrics_logger.path) as f:
            rec = next(json.loads(line) for line in f if '"train/' in line)
        assert rec["step"] == 1
        return {k: v for k, v in rec.items()
                if k.startswith("train/") and k.endswith("loss")
                and "reference" not in k}

    cpu, card = map(step1, runs)
    assert cpu.keys() == card.keys() and "train/flow_loss" in cpu
    for k in cpu:
        assert abs(card[k] - cpu[k]) <= 5e-2 * abs(cpu[k]), (k, card[k], cpu[k])
    assert runs[1].ddi_runs == 1 and runs[1].version == 1
    assert all(ops.LAUNCHES[k] > 0 for k in
               ("nice_net", "nice_net_train", "macow_unit_inverse", "spade_gn"))
    resumed = env.run(path, "--resume", device="cuda")
    assert (resumed.version, resumed.step, resumed.tx.count, resumed.ddi_runs) \
        == (1, 4, 4, 0)


def _eval_net_case(name):
    """(net on the CPU, its inputs) of one evaluation net at a toy size:
    fixed-seed weights, inputs from a numpy seed."""
    from ipoke_tpu_torch.eval.i3d import init_i3d
    from ipoke_tpu_torch.eval.pose import build_pose_resnet
    from ipoke_tpu_torch.nn.lpips import init_lpips

    rng = np.random.default_rng(0)

    def x(*shape):
        return torch.as_tensor(np.clip(0.5 * rng.standard_normal(shape), -1, 1)
                               .astype(np.float32))

    if name.startswith("lpips"):
        c = int(name[-1])
        return init_lpips(0), (x(6, 32, 32, c), x(6, 32, 32, c))
    if name == "i3d":
        return init_i3d(0), (x(2, 10, 32, 32, 3),)
    return build_pose_resnet(), (x(4, 64, 64, 3),)


# the evaluation nets (``--test`` accuracy, diversity, fvd, kps_acc), card
# against the CPU port, fp32 with TF32 off: cuDNN and oneDNN sum their
# convolutions in other orders, ~1e-6 relative a layer; a wrong layout or
# padding moves the output by O(1).  LPIPS within 1e-4 relative; I3D's
# logits and features and PoseResNet's heatmaps within 1e-3 abs + rel
@pytest.mark.parametrize("name,tol", [("lpips3", 1e-4), ("lpips2", 1e-4),
                                      ("i3d", 1e-3), ("pose", 1e-3)])
def test_eval_nets_card_match_cpu(dev, name, tol):
    net, inputs = _eval_net_case(name)
    kw = {"return_features": True} if name == "i3d" else {}
    with torch.no_grad():
        want = net(*inputs, **kw)
        got = copy.deepcopy(net).to(dev)(*(t.to(dev) for t in inputs), **kw)
    if name == "i3d":  # logits and features
        want, got = torch.cat(want, -1), torch.cat(got, -1)
    assert torch.isfinite(got).all()
    if name.startswith("lpips"):
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=0.0)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    assert not any(ops.LAUNCHES.values())  # no kernel of ops/ on this path
