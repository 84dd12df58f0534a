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

from ipoke_tpu_torch import entry, ops
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


@pytest.mark.parametrize("m,c1,hid,cout", [(512, 16, 256, 32), (100, 5, 128, 3),
                                           (2560, 30, 2048, 4)])
def test_nice_net_kernel_matches_plain(dev, m, c1, hid, cout):
    """K1 at a ragged row count and with K1 and N padded to 16."""
    zcol = _randn(dev, m, 9 * c1, seed=1).bfloat16()
    w1 = _randn(dev, 9 * c1, hid, std=(9 * c1) ** -0.5, seed=2).bfloat16()
    w2 = _randn(dev, hid, hid, std=hid ** -0.5, seed=3).bfloat16()
    wp = _randn(dev, hid, 9 * cout, std=(9 * hid) ** -0.5, seed=4).bfloat16()
    got = nice_net.nice_net_cuda(zcol, w1, w2, wp)
    want = nice_net.nice_net_plain(zcol, w1, w2, wp)
    assert got.shape == (m, 9 * cout) and ops.LAUNCHES["nice_net"] == 1
    torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("m,c1,hid,cout", [(512, 16, 256, 32), (100, 5, 128, 3),
                                           (2560, 30, 2048, 4)])
def test_nice_net_train_kernel_matches_plain(dev, m, c1, hid, cout):
    """K4 at a ragged row count (the last block stores 4 rows of a and b):
    u, a and b against the plain version, u bitwise K1's."""
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


@pytest.mark.parametrize("b,s,c,ch", [(3, 8, 8, 6), (2, 4, 4, 0), (40, 8, 32, 128)])
def test_unit_inverse_kernel_matches_plain(dev, b, s, c, ch):
    """K2 with and without conditioning, at a 4x4 latent too."""
    hid = 4 * c
    mcf = []
    for i in range(4):
        w_shift = _randn(dev, 2, 3, c, hid, std=(6 * c) ** -0.5, seed=10 + i)
        mcf.append({"w_shift": w_shift.transpose(0, 1) if i >= 2 else w_shift,
                    "out": {"v": _randn(dev, 1, 1, hid + ch, 2 * c, std=0.05, seed=20 + i),
                            "g": _randn(dev, 2 * c, std=0.3, seed=30 + i),
                            "b": _randn(dev, 2 * c, std=0.1, seed=40 + i)}})
    an = [{"log_scale": _randn(dev, c, std=0.05, seed=50 + i),
           "bias": _randn(dev, c, std=0.05, seed=60 + i)} for i in range(2)]
    y = _randn(dev, b, s, s, c, seed=70)
    h = _randn(dev, b, s, s, ch, seed=71) if ch else None
    packed = masked_conv.pack_unit(h, mcf, an, b, s, s)
    got = masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0)
    want = masked_conv.macow_unit_inverse_plain(y, *packed, 1.0)
    assert ops.LAUNCHES["macow_unit_inverse"] == 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


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
    entry.perturb(model, gen, 0.03, 0.03)
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
    entry.perturb(model, gen, 0.03, 0.03)
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
