"""The port's kernel wrappers (ipoke_tpu_torch/ops) against the JAX
package's Pallas kernels in interpret mode, on CPU tensors: there the
wrappers run their plain PyTorch versions.  K4's backward is held against
``jax.grad`` of the JAX package's custom vjp.  Inputs come from numpy
seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.flows.macow import NICE2d, make_macow_unit
from ipoke_tpu.ops.masked_conv import (
    macow_unit_inverse_pallas,
    masked_conv_inverse_pallas,
)
from ipoke_tpu.ops import nice_net as jnice
from ipoke_tpu.ops.nice_net import nice_net_raw_pallas
from ipoke_tpu.ops.spade_gn import _portable as jax_spade_gn_portable
from ipoke_tpu.ops.spade_gn import spade_gn_modulate_pallas
from ipoke_tpu_torch import ops
from ipoke_tpu_torch.convert import flow_params, to_numpy_tree
from ipoke_tpu_torch.ops import _build
from ipoke_tpu_torch.ops.masked_conv import (
    k5_cluster,
    k5_fits,
    k5_smem_bytes,
    macow_unit_inverse,
    masked_conv_inverse,
)
from ipoke_tpu_torch.ops.nice_net import (
    _train_forward,
    nice_net_fits,
    nice_net_raw,
    nice_net_raw_train,
)
from ipoke_tpu_torch.ops.spade_gn import (
    SpadeGN,
    spade_gn_modulate,
    spade_gn_plain,
    spade_gn_plan,
)

B, H, W = 2, 8, 8


def _perturb(tree, rng, g_std, b_std):
    """Non-trivial out convs (zero-initialised g) and ActNorms, in place."""
    if isinstance(tree, dict):
        if {"v", "g", "b"} <= tree.keys():
            tree["g"] = (g_std * rng.standard_normal(tree["g"].shape)).astype(np.float32)
            tree["b"] = (b_std * rng.standard_normal(tree["b"].shape)).astype(np.float32)
        elif {"log_scale", "bias"} <= tree.keys():
            tree["bias"] = (b_std * rng.standard_normal(tree["bias"].shape)).astype(np.float32)
        for v in tree.values():
            _perturb(v, rng, g_std, b_std)
    elif isinstance(tree, list):
        for v in tree:
            _perturb(v, rng, g_std, b_std)
    return tree


def _jnp(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if dtype is not None and a.dtype.kind == "f"
        else jnp.asarray(a), tree)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a, np.float32)).to(dtype)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One torch thread in each test module that takes this fixture (it
    imports it): the suite runs its files in parallel workers, where each
    worker's default thread pool would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _zero_launches():
    ops.reset_launches()
    yield
    # on CPU tensors the wrappers run their plain versions: no launch counted
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


# ---------------------------------------------------------------------------
# K1: the NICE coupling net
# ---------------------------------------------------------------------------

def _nice(h_channels, factor, split, seed, in_channels=8, hidden=256):
    nice = NICE2d(in_channels, hidden_channels=hidden, h_channels=h_channels,
                  split_type=split, order="up", factor=factor)
    rng = np.random.default_rng(seed)
    params = _perturb(to_numpy_tree(nice.init(jax.random.PRNGKey(seed), None)),
                      rng, 0.3, 0.1)
    x = rng.standard_normal((B, H, W, in_channels)).astype(np.float32)
    h = rng.standard_normal((B, H, W, h_channels)).astype(np.float32) \
        if h_channels else None
    return nice, params, x, h


@pytest.mark.parametrize("h_channels,factor,split,dtype,tol", [
    (0, 2, "continuous", "float32", 2e-4),
    (6, 2, "continuous", "float32", 2e-4),
    (0, 4, "continuous", "float32", 2e-4),
    (0, 2, "skip", "float32", 2e-4),
    (0, 2, "continuous", "bfloat16", 5e-2),
])
def test_nice_net_plain_matches_pallas(h_channels, factor, split, dtype, tol):
    nice, params, x, h = _nice(h_channels, factor, split, 50 + h_channels + factor)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    z = nice._split(jnp.asarray(x, jdt))[0]
    hj = None if h is None else jnp.asarray(h, jdt)
    want = nice_net_raw_pallas(_jnp(params, jdt), z, hj, interpret=True)
    pt = flow_params(params, dtype=tdt)
    zt = _t(z, tdt)
    ht = None if h is None else _t(h, tdt)
    assert nice_net_fits(pt, zt, ht)
    got = nice_net_raw(pt, zt, ht)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)


def test_nice_net_family():
    """The kernel's static family: conditioning rows need h, the hidden
    width is a multiple of 128, at most 512 pixels per image."""
    nice, params, x, h = _nice(6, 2, "continuous", 80)
    pt = flow_params(params)
    z, ht = _t(x[..., :4]), _t(h)
    assert nice_net_fits(pt, z, ht)
    assert not nice_net_fits(pt, z, None)
    assert not nice_net_fits(dict(pt, w1=torch.zeros(3, 3, 4, 200)), z, ht)
    assert not nice_net_fits(pt, torch.zeros(B, 32, 32, 4), ht)


# ---------------------------------------------------------------------------
# K4: the NICE train forward and its backward
# ---------------------------------------------------------------------------

def _leaves(p):
    return [p["w1"], p["w2"], p["out"]["v"], p["out"]["g"], p["out"]["b"]]


@pytest.mark.parametrize("h_channels", [0, 6])
def test_nice_net_train_plain_matches_pallas(h_channels):
    """K4's forward (plain on CPU): raw and the stored post-ELU hiddens
    against ``_train_impl`` in interpret mode, fp32."""
    nice, params, x, h = _nice(h_channels, 2, "continuous", 100 + h_channels)
    z = nice._split(jnp.asarray(x))[0]
    hj = None if h is None else jnp.asarray(h)
    want = jnice._train_impl(_jnp(params), z, hj, interpret=True)
    got = _train_forward(flow_params(params), _t(z),
                         None if h is None else _t(h))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w).reshape(g.shape),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("h_channels", [0, 6])
def test_nice_net_train_grads_match_jax(h_channels):
    """Autograd through K4's Function (hand-written backward) against
    ``jax.grad`` of the JAX package's ``nice_net_raw_train`` (its custom vjp
    over the interpret-mode kernel), for every param, z and h."""
    nice, params, x, h = _nice(h_channels, 2, "continuous", 110 + h_channels)
    z = nice._split(jnp.asarray(x))[0]
    hj = None if h is None else jnp.asarray(h)
    loss = lambda p, zz, hh: jnp.sum(jnp.sin(jnice.nice_net_raw_train(True, p, zz, hh)))
    want = jax.grad(loss, argnums=(0, 1, 2) if h is not None else (0, 1))(
        _jnp(params), z, hj)
    pt = flow_params(params)
    ins = _leaves(pt) + [_t(z)] + ([] if h is None else [_t(h)])
    for t in ins:
        t.requires_grad_(True)
    out = nice_net_raw_train(pt, ins[5], ins[6] if h is not None else None)
    got = torch.autograd.grad(torch.sin(out).sum(), ins)
    flat = [want[0]["w1"], want[0]["w2"], want[0]["out"]["v"],
            want[0]["out"]["g"], want[0]["out"]["b"], *want[1:]]
    for g, w in zip(got, flat):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h_channels", [0, 6])
def test_nice_net_train_primal_matches_fwd_rule(h_channels, dtype):
    """The no-grad path (K1) and the train path (K4) give the same raw
    bitwise: under remat the loss comes from the first, the gradients from
    the second."""
    nice, params, x, h = _nice(h_channels, 2, "continuous", 140 + h_channels)
    tdt = getattr(torch, dtype)
    pt = flow_params(params, dtype=tdt)
    z = _t(x[..., :4], tdt)
    ht = None if h is None else _t(h, tdt)
    with torch.no_grad():
        primal = nice_net_raw(pt, z, ht)
    for t in _leaves(pt):
        t.requires_grad_(True)
    train = nice_net_raw_train(pt, z, ht)
    assert train.requires_grad and torch.equal(primal, train.detach())


def test_nice_net_train_bf16_grad_dtypes():
    """bf16 primals get bf16 cotangents (the master-weights contract)."""
    nice, params, x, h = _nice(6, 2, "continuous", 120)
    pt = flow_params(params, dtype=torch.bfloat16)
    ins = _leaves(pt) + [_t(x[..., :4], torch.bfloat16), _t(h, torch.bfloat16)]
    for t in ins:
        t.requires_grad_(True)
    out = nice_net_raw_train(pt, ins[5], ins[6])
    for g in torch.autograd.grad(out.float().sum(), ins):
        assert g.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# K2: the MaCowUnit inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h_channels", [0, 6])
def test_unit_inverse_plain_matches_pallas(h_channels):
    c = 8
    unit = make_macow_unit(c, (2, 3), h_channels=h_channels)
    rng = np.random.default_rng(20 + h_channels)
    params = _perturb(to_numpy_tree(unit.init(jax.random.PRNGKey(22), None)),
                      rng, 0.3, 0.1)
    x = rng.standard_normal((B, H, W, c)).astype(np.float32)
    h = rng.standard_normal((B, H, W, h_channels)).astype(np.float32) \
        if h_channels else None
    pj = _jnp(params)
    hj = None if h is None else jnp.asarray(h)
    y, _ = unit.forward(pj, jnp.asarray(x), hj)
    want = macow_unit_inverse_pallas(y, hj, [pj[0], pj[1], pj[3], pj[4]],
                                     [pj[2], pj[5]], (2, 3), 1.0, interpret=True)
    pt = flow_params(params)
    got = macow_unit_inverse(_t(y), None if h is None else _t(h),
                             [pt[0], pt[1], pt[3], pt[4]], [pt[2], pt[5]],
                             (2, 3), 1.0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-3)


# ---------------------------------------------------------------------------
# K5: the inverse of one masked-conv flow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(8, 8), (4, 8)])
@pytest.mark.parametrize("h_channels", [0, 6])
@pytest.mark.parametrize("order", ["A", "B", "C", "D"])
def test_masked_conv_inverse_plain_matches_pallas(order, h_channels, hw):
    """K5's plain version (the flow's route on CPU tensors) against
    ``masked_conv_inverse_pallas`` in interpret mode, orders A-D, with and
    without conditioning rows, on a square and a non-square latent.  g/b are
    set directly: ``ddi`` would leave g = 0 and the recurrence trivial."""
    c, hid = 8, 32
    kh, kw = (2, 3) if order in ("A", "B") else (3, 2)  # C/D store them swapped
    rng = np.random.default_rng(200 + ord(order) + h_channels + hw[0])
    n = lambda *s, std=1.0: (std * rng.standard_normal(s)).astype(np.float32)
    params = {"w_shift": n(kh, kw, c, hid, std=(kh * kw * c) ** -0.5),
              "out": {"v": n(1, 1, hid + h_channels, 2 * c, std=0.05),
                      "g": n(2 * c, std=0.3), "b": n(2 * c, std=0.1)}}
    y = n(B, *hw, c)
    h = n(B, *hw, h_channels) if h_channels else None
    v = params["out"]["v"]
    w_out = (v * (params["out"]["g"] / np.sqrt((v * v).sum((0, 1, 2)) + 1e-12)))[0, 0]
    pallas = jax.jit(functools.partial(masked_conv_inverse_pallas, order=order,
                                       interpret=True))
    want = pallas(jnp.asarray(y), None if h is None else jnp.asarray(h),
                  jnp.asarray(params["w_shift"]), jnp.asarray(w_out),
                  jnp.asarray(params["out"]["b"]))
    got = masked_conv_inverse(_t(y), None if h is None else _t(h),
                              flow_params(params), order)
    assert got.dtype == torch.float32 and got.shape == y.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)


# K5's cluster per batch item at each SHIPPED level's hid = 4C (C = 32, 30,
# ..., 4): the fewest CTAs that hold the hidden units at most 32 a CTA
@pytest.mark.parametrize("c,k", [(32, 4), (18, 4), (16, 2), (10, 2), (8, 1), (4, 1)])
def test_k5_cluster_by_level(c, k):
    assert k5_cluster(4 * c) == k


def test_k5_fits_by_shape():
    """K5 takes every latent of the 8x16 path (A/B rows of 16 columns, C/D
    rows of 8, at every shipped level), its card-test shapes (W = 7 and 13,
    C = 4 and 8) and a 32x32x32 latent, at any number of rows; it refuses
    rows over 1024 elements, hid not a multiple of 4, kw other than 3 and
    more than 16 tap groups.  Its footprint grows with W, not H."""
    for c in range(32, 2, -2):
        for width in (16, 8):
            assert k5_fits((40, 24 - width, width, c), 4 * c, (2, 3)), (c, width)
    for shape, hid in (((3, 5, 7, 8), 32), ((2, 13, 6, 8), 32), ((2, 8, 8, 4), 16),
                       ((40, 32, 32, 32), 128), ((1, 4096, 8, 32), 128)):
        assert k5_fits(shape, hid, (2, 3)), shape
    for shape, hid, ks in (((2, 2, 256, 32), 128, (2, 3)), ((1, 8, 33, 32), 128, (2, 3)),
                           ((1, 8, 8, 8), 30, (2, 3)), ((1, 8, 8, 8), 32, (2, 5)),
                           ((1, 8, 8, 36), 144, (2, 3)), ((1, 8, 8, 32), 512, (2, 3))):
        assert not k5_fits(shape, hid, ks), shape
    # C = 32, hid 128, clusters of 4: 32 hidden units a CTA
    assert k5_smem_bytes(16, 32, 128, 2, 3, 4) == 4 * (
        16 // 4 + 6 * 32 * 32 + 32 * 64 + 2 * 18 * 32 + 16 * 36 + 4 * 16 * 32)


# ---------------------------------------------------------------------------
# K3: SPADE GroupNorm + modulation
# ---------------------------------------------------------------------------

def test_spade_gn_backward_matches_plain_and_jax_vjp():
    """K3's autograd Function, driven here with the plain version as its
    forward, gives the gradients of x, gamma and beta that autograd of the
    plain version gives, and those of ``jax.vjp`` of the JAX package's
    portable form (the backward of its ``spade_gn_fused``; run eagerly),
    in fp32 with 2 clips of 2 frames."""
    rng = np.random.default_rng(7)
    x = (2.0 * rng.standard_normal((4, 4, 4, 32)) + 0.5).astype(np.float32)
    gamma, beta, ct = ((0.5 * rng.standard_normal(shape)).astype(np.float32)
                       for shape in ((2, 4, 4, 32), (2, 4, 4, 32), (4, 4, 4, 32)))
    leaves = [_t(a).requires_grad_() for a in (x, gamma, beta)]
    out = SpadeGN.apply(spade_gn_plain, *leaves, 16, 1e-5)
    got = torch.autograd.grad(out, leaves, _t(ct))
    ref = [t.detach().requires_grad_() for t in leaves]
    want = torch.autograd.grad(spade_gn_plain(*ref, 16, 1e-5), ref, _t(ct))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, vjp = jax.vjp(lambda a, g_, b_: jax_spade_gn_portable(a, g_, b_, 16, 1e-5),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    for g, w in zip(got, vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=2e-5, rtol=2e-5)


def test_refuse_grad():
    """A kernel without a backward refuses a tensor that requires grad while
    autograd records, and takes it under ``no_grad``."""
    x, w = torch.ones(2, requires_grad=True), torch.ones(2)
    with pytest.raises(RuntimeError, match="k5: the kernel has no backward"):
        _build.refuse_grad("k5", w, x)
    _build.refuse_grad("k5", w, x.detach())
    with torch.no_grad():
        _build.refuse_grad("k5", w, x)


@pytest.mark.parametrize("shape,clips,dtype,tol", [
    ((6, 8, 8, 32), 2, "float32", 2e-5),
    ((4, 4, 4, 256), 2, "float32", 2e-5),
    ((6, 8, 8, 32), 2, "bfloat16", 3e-2),
    ((4, 4, 4, 256), 4, "bfloat16", 3e-2),
])
def test_spade_gn_plain_matches_pallas(shape, clips, dtype, tol):
    rng = np.random.default_rng(sum(shape) + clips)
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    mshape = (clips, *shape[1:])
    gamma = (0.5 * rng.standard_normal(mshape)).astype(np.float32)
    beta = (0.5 * rng.standard_normal(mshape)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = spade_gn_modulate_pallas(jnp.asarray(x, jdt), jnp.asarray(gamma, jdt),
                                    jnp.asarray(beta, jdt), 16, 1e-5,
                                    interpret=True)
    got = spade_gn_modulate(_t(x, tdt), _t(gamma, tdt), _t(beta, tdt), 16, 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)


# K3's cluster per frame at each decode level (S, Ch) of the SHIPPED config:
# (k, slice kept in shared memory) in bf16 and in fp32
@pytest.mark.parametrize("s,ch,bf16,fp32", [
    (128, 64, (16, True), (16, False)),
    (64, 128, (8, True), (16, True)),
    (32, 256, (4, True), (8, True)),
    (16, 256, (1, True), (2, True)),
])
def test_spade_gn_plan_by_level(s, ch, bf16, fp32):
    """k is the smallest power of two up to 16 that makes a CTA's slice at
    most 128 KB; only an fp32 128 px frame (4 MiB) stays over it and streams
    its slices.  The plan reads the shape and the dtype only."""
    assert spade_gn_plan(s * s, ch, 2) == bf16
    assert spade_gn_plan(s * s, ch, 4) == fp32


def test_spade_gn_plan_ragged_and_narrow():
    """A frame whose pixels do not split evenly (45x45 in bf16 over 2 CTAs
    keeps ceil(2025 / 2) = 1013 pixels, 129,664 bytes, a CTA), a tiny frame
    (one CTA per frame), and pixel rows that are not a multiple of 16 bytes
    (streamed)."""
    assert spade_gn_plan(45 * 45, 64, 2) == (2, True)
    assert spade_gn_plan(25, 48, 4) == (1, True)
    assert spade_gn_plan(81, 20, 2) == (1, False)


# ---------------------------------------------------------------------------
# the CUDA build
# ---------------------------------------------------------------------------

def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
