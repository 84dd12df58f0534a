"""The second stage's flow options in the port (ipoke_tpu_torch.flows)
against the JAX package's, on the CPU in fp32, with the same weights and
inputs (numpy seeds): the ``additive`` and ``relu`` transforms, masked-conv
and NICE couplings over them (the plain row scan of a non-affine inverse),
``InvConvLU`` (``use1x1``), ``SpaceToDepth``, ``MultiscaleStack`` with each
``reshape``, the three alternative losses, and K5's reach (ROADMAP queue 3
fault (d)).  The flows' JAX references come from one jitted program (the
``refs`` fixture); the elementwise pieces run eagerly."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from ipoke_tpu.flows import build_macow_transformer as jbuild
from ipoke_tpu.flows import loss as jloss
from ipoke_tpu.flows import macow as jm
from ipoke_tpu.flows import primitives as jp
from ipoke_tpu_torch.convert import flow_params
from ipoke_tpu_torch.flows import ParamTree
from ipoke_tpu_torch.flows import build_macow_transformer as tbuild
from ipoke_tpu_torch.flows import loss as tloss
from ipoke_tpu_torch.flows import macow as tm
from ipoke_tpu_torch.flows import primitives as tp
from ipoke_tpu_torch.ops.masked_conv import (
    k5_cluster,
    k5_fits,
    k5_streamed,
    masked_conv_inverse_cuda,
    unit_fits,
)

from test_torch_density import leaves
from test_torch_ops import _few_threads, _jnp, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _STD

B, HC = 2, 6  # batch, conditioning channels
TOL = 2e-4


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _lu(c, rng):
    """InvConvLU values as its init makes them (LU of the Q of a QR), with
    the free leaves moved off it a little."""
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    p, lower, upper = scipy.linalg.lu(q)
    s = np.diag(upper)
    f = lambda a: np.asarray(a, np.float32)
    noise = lambda: 0.05 * rng.standard_normal((c, c))
    return {"buf_p": f(p), "buf_sign_s": f(np.sign(s)),
            "l": f(np.tril(lower, -1) + np.tril(noise(), -1)),
            "u": f(np.triu(upper, 1) + np.triu(noise(), 1)),
            "log_s": f(np.log(np.abs(s)) + 0.05 * rng.standard_normal(c))}


def fill(tree, rng):
    """numpy values for a tree of ShapeDtypeStructs: fan-in-scaled kernels,
    permutations, LU factors, non-trivial out convs and ActNorms."""
    if isinstance(tree, (list, tuple)):
        return [fill(v, rng) for v in tree]
    if not isinstance(tree, dict):  # a bare kernel (MultiscaleStack's h_transforms)
        return (rng.standard_normal(tree.shape)
                * np.prod(tree.shape[-4:-1]) ** -0.5).astype(np.float32)
    if "buf_p" in tree:
        return _lu(tree["l"].shape[-1], rng)
    out = {}
    if "buf_perm" in tree:
        shape = tree["buf_perm"].shape
        perm = np.stack([rng.permutation(shape[-1])
                         for _ in range(int(np.prod(shape[:-1])))]).reshape(shape)
        out["buf_perm"] = perm.astype(np.int32)
        out["buf_inv_perm"] = np.argsort(perm, axis=-1).astype(np.int32)
    for key, v in tree.items():
        if key in out:
            continue
        if not hasattr(v, "shape"):
            out[key] = fill(v, rng)
            continue
        k = key.rsplit("/", 1)[-1]  # spectral norm stats: "Conv_0/kernel/u"
        noise = rng.standard_normal(v.shape).astype(np.float32)
        if k == "sigma":
            out[key] = np.ones(v.shape, np.float32)
        elif k in ("scale", "gamma"):
            out[key] = 1.0 + 0.1 * noise
        elif k in _STD or k == "beta":
            out[key] = _STD.get(k, 0.05) * noise
        else:  # HWIO kernels, possibly stacked
            out[key] = noise * np.float32(np.prod(v.shape[-4:-1]) ** -0.5)
    return out


def lu_traceable():
    """InvConvLU's init leaves JAX for numpy and scipy: inside this context
    it is traceable for its shapes (values from ``fill``)."""
    zeros = lambda self, rng, x_shape=None: dict.fromkeys(
        ("buf_p", "l", "u", "buf_sign_s", "log_s"), jnp.zeros((self.channels,) * 2))
    return mock.patch.object(jp.InvConvLU, "init", zeros)


# name -> (architecture or coupling, latent (H, W, C))
STACK = dict(h_channels=HC, flow_mid_channels_factor=4, kernel_size=[2, 3],
             multistack=True, levels=[[1], [1]])
CASES = {
    "mcf_additive": (("mcf", "additive"), (4, 5, 4)),
    "mcf_relu": (("mcf", "relu"), (4, 5, 4)),
    "nice_additive": (("nice", "additive"), (4, 4, 6)),
    "nice_relu": (("nice", "relu"), (4, 4, 6)),
    "stack_none": (dict(STACK, flow_in_channels=8, factors=[4, 4], reshape="none",
                        use1x1=True), (4, 4, 8)),
    "stack_up": (dict(STACK, flow_in_channels=16, factors=[4, 4], reshape="up",
                      transform="additive", prior_transform="relu"), (4, 4, 16)),
    "stack_down": (dict(STACK, flow_in_channels=4, factors=[2, 4], reshape="down"),
                   (8, 8, 4)),
}


def _flows(name):
    """(JAX flow, port flow) of a case."""
    arch, _ = CASES[name]
    if isinstance(arch, dict):
        return jbuild(arch), tbuild(arch)
    kind, tr = arch
    if kind == "mcf":
        kw = dict(in_channels=4, kernel_size=(2, 3), order="B", h_channels=HC,
                  transform=tr)
        return jm.MaskedConvFlow(**kw), tm.MaskedConvFlow(**kw)
    kw = dict(in_channels=6, hidden_channels=16, h_channels=HC, split_type="skip",
              order="down", transform=tr)
    return jm.NICE2d(**kw), tm.NICE2d(**kw)


@pytest.fixture(scope="module")
def refs():
    """Per case: numpy params, inputs, and the JAX package's forward and
    the inverse of its output; for a coupling the inverse of a draw of the
    output's shape, for a stack its DDI; and InvConvLU's
    forward and inverse in fp32 and from bf16 params.  One jitted program."""
    values, inputs = {}, {}
    rng = np.random.default_rng(0)
    for i, name in enumerate(CASES):
        jflow, _ = _flows(name)
        with lu_traceable():
            shapes = jax.eval_shape(lambda f=jflow: f.init(jax.random.PRNGKey(0)))
        values[name] = fill(shapes, rng)
        shape = CASES[name][1]
        inputs[name] = (_x((B, *shape), 10 + i), _x((B, *shape[:2], HC), 30 + i),
                        _x((B, *jflow.output_shape(shape)), 70 + i))
    lu = jp.InvConvLU(8)
    values["lu"] = _lu(8, rng)
    inputs["lu"] = (_x((B, 3, 4, 8), 50), None, None)

    def program(values, inputs):
        out = {}
        for name in CASES:
            jflow, _ = _flows(name)
            p, (x, h, z) = values[name], inputs[name]
            y, ld = jflow.forward(p, x, h)
            o = {"y": y, "ld": ld, "round": jflow.inverse(p, y, h)}
            if isinstance(CASES[name][0], dict):
                yd, ldd, pd = jflow.ddi(p, x, h)
                o.update(ddi_y=yd, ddi_ld=ldd, ddi_params=pd)
            else:  # a stack's inverse is held on its forward's output only
                o["inv"] = jflow.inverse(p, z, h)
            out[name] = o
        p, x = values["lu"], inputs["lu"][0]
        p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        y, ld = lu.forward(p, x)
        y16, _ = lu.forward(p16, x.astype(jnp.bfloat16))
        out["lu"] = {"y": y, "ld": ld, "inv": lu.inverse(p, x),
                     "y16": y16, "inv16": lu.inverse(p16, x.astype(jnp.bfloat16))}
        return out

    want = jax.jit(program)(_jnp(values), _jnp(inputs))
    return values, inputs, jax.tree_util.tree_map(np.asarray, want)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _port(refs, name):
    values, inputs, want = refs
    x, h, z = inputs[name]
    return (_flows(name)[1], flow_params(values[name]), _t(x), _t(h), _t(z),
            want[name])


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["additive", "relu"])
def test_transform_matches_jax(name):
    """fwd, bwd and logdet of the elementwise transform at 1e-5, and bwd
    inverts fwd."""
    raw = _x((B, 3, 4, 4 * jp.get_transform(name).n_params), 1)
    z = _x((B, 3, 4, 4), 2)
    jt, tt = jp.get_transform(name), tp.get_transform(name)
    jpar, tpar = jt.calc(jnp.asarray(raw)), tt.calc(_t(raw))
    jy, jld = jt.fwd(jnp.asarray(z), jpar)
    ty, tld = tt.fwd(_t(z), tpar)
    close(ty, jy, 1e-5)
    close(tld, jld, 1e-5)
    close(tt.bwd(_t(z), tpar), jt.bwd(jnp.asarray(z), jpar), 1e-5)
    close(tt.bwd(ty, tpar), z, 1e-5)
    with pytest.raises(ValueError, match="unknown transform"):
        tp.get_transform("spline")


# ---------------------------------------------------------------------------
# couplings over the non-affine transforms, InvConvLU, SpaceToDepth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mcf_additive", "mcf_relu", "nice_additive",
                                  "nice_relu"])
def test_non_affine_coupling_matches_jax(refs, name):
    """Forward, logdet and inverse (the plain row scan for a masked-conv
    flow, which K5 does not take) at 2e-4."""
    flow, p, x, h, z, want = _port(refs, name)
    y, ld = flow.forward(p, x, h)
    close(y, want["y"])
    close(ld, want["ld"])
    close(flow.inverse(p, z, h), want["inv"])
    close(flow.inverse(p, y, h), x, 1e-4)


def test_inv_conv_lu_matches_jax(refs):
    """Forward, inverse and logdet at 1e-5; the logdet is slogdet(W) per
    pixel; the init is a rotation's LU (|det W| = 1)."""
    values, inputs, want = refs
    lu = tp.InvConvLU(8)
    p, x = flow_params(values["lu"]), _t(inputs["lu"][0])
    y, ld = lu.forward(p, x)
    close(y, want["lu"]["y"], 1e-5)
    close(ld, want["lu"]["ld"], 1e-5)
    close(lu.inverse(p, x), want["lu"]["inv"], 1e-5)
    close(lu.inverse(p, y), x, 1e-5)
    sign, logabs = torch.linalg.slogdet(lu.weight(p).double())
    assert sign.item() != 0
    close(ld, np.full(B, logabs.item() * 12), 1e-5)
    init = lu.init(torch.Generator().manual_seed(0), "cpu")
    assert torch.allclose(init["log_s"].sum(), torch.zeros(()), atol=1e-5)
    tree = ParamTree(init)
    assert {n for n, _ in tree.named_buffers()} == {"buf_p", "buf_sign_s"}
    assert {n for n, _ in tree.named_parameters()} == {"l", "u", "log_s"}


def test_inv_conv_lu_bf16_params(refs):
    """From bf16 params both packages form W in fp32 (the JAX package's
    masks promote it) and invert it: the same forward and inverse within
    bf16 rounding, and the inverse undoes the forward."""
    values, inputs, want = refs
    lu = tp.InvConvLU(8)
    p16 = flow_params(values["lu"], dtype=torch.bfloat16)
    x16 = _t(inputs["lu"][0], torch.bfloat16)
    y16, _ = lu.forward(p16, x16)
    assert y16.dtype == torch.bfloat16
    close(y16, want["lu"]["y16"], 2e-2)
    inv = lu.inverse(p16, x16)
    close(inv, want["lu"]["inv16"], 2e-2)
    close(lu.inverse(p16, y16), x16.float(), 5e-2)


def test_space_to_depth_matches_jax():
    """Both directions bit for bit, channels in (dy, dx, c) order."""
    x = _x((B, 4, 6, 3), 3)
    for inv in (False, True):
        jf, tf = jp.SpaceToDepth(inv), tp.SpaceToDepth(inv)
        xi = x.reshape(B, 2, 3, 12) if inv else x
        jy, _ = jf.forward({}, jnp.asarray(xi))
        ty, tld = tf.forward({}, _t(xi))
        assert np.array_equal(ty.numpy(), np.asarray(jy))
        assert np.array_equal(tf.inverse({}, ty).numpy(), xi)
        assert not tld.any()


# ---------------------------------------------------------------------------
# MultiscaleStack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["stack_none", "stack_up", "stack_down"])
def test_multiscale_stack_matches_jax(refs, name):
    """Forward, logdet, the inverse of the forward's output and DDI
    (output, logdet, new params) at 2e-4, and inverse(forward) at 1e-4 (the
    port's and JAX's); the output shape follows ``reshape``."""
    flow, p, x, h, _, want = _port(refs, name)
    y, ld = flow.forward(p, x, h)
    assert tuple(y.shape[1:]) == flow.output_shape(x.shape[1:])
    close(y, want["y"])
    close(ld, want["ld"])
    x_back = flow.inverse(p, y, h)
    close(x_back, want["round"])
    close(x_back, x, 1e-4)
    close(_t(want["round"]), x, 1e-4)
    yd, ldd, pd = flow.ddi(p, x, h)
    close(yd, want["ddi_y"])
    close(ldd, want["ddi_ld"])
    got, ref = leaves(pd), leaves(want["ddi_params"])
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        close(a, b)


# ---------------------------------------------------------------------------
# losses, K5's reach
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["flow_loss_alternative", "gaussian_logp",
                                  "nll_with_typicality"])
def test_alternative_loss_matches_jax(loss):
    z, ld = _x((3, 4, 4, 8), 4), _x((3,), 5, 10.0)
    args = (12,) if loss == "nll_with_typicality" else ()
    jl, jlog = getattr(jloss, loss)(jnp.asarray(z), jnp.asarray(ld), *args)
    tl, tlog = getattr(tloss, loss)(_t(z), _t(ld), *args)
    assert tlog.keys() == jlog.keys()
    close(tl, jl, 1e-6)
    for k in jlog:
        close(torch.as_tensor(tlog[k]), jlog[k], 1e-6)


def test_k5_and_k2_refuse_the_down_stack():
    """MultiscaleStack ``reshape: down`` over the shipped 8x8x32 first stage
    (levels [[4,3,2],[4,3,2]], factors [16, 4]) puts its second block at
    4x4 with C = 128, 96, 64 and MCF hidden ``default_mcf_hidden(C)`` =
    256, 384, 256.  K2 takes none of these units; K5's gate takes every
    flow of them (its wide path streams the tap weights from shared
    memory).  Past shared memory its streamed instance takes the flow: a
    2x2x512 flow at hid 512 (786 KB of w_shift a CTA at a cluster of 8),
    4x4x256 at hid 2048 and a row of 16x128 elements.  It refuses only a
    hid that is not a multiple of 4 or kw other than 3, and the wrapper
    raises naming that gate before it touches the card."""
    for c, hid in ((128, 256), (96, 384), (64, 256)):
        assert tm.default_mcf_hidden(c) == hid
        assert not unit_fits((40, 4, 4, c), hid, (2, 3))
        assert k5_fits((40, 4, 4, c), hid, (2, 3))
    assert k5_fits((40, 4, 4, 32), 128, (2, 3))
    for shape, hid in (((1, 2, 2, 512), 512), ((40, 4, 4, 256), 2048),
                       ((2, 16, 16, 128), 256)):
        assert k5_fits(shape, hid, (2, 3)) and not unit_fits(shape, hid, (2, 3))
        assert k5_streamed(shape[2], shape[3], hid, 2, 3, k5_cluster(hid))
    y, w_shift = torch.zeros(1, 2, 2, 512), torch.zeros(2, 3, 512, 510)
    with pytest.raises(ValueError, match=r"k5_fits: hid a multiple of 4") as err:
        masked_conv_inverse_cuda(y, w_shift, torch.zeros(510, 1024),
                                 torch.zeros(1, 2, 2, 1024), 1.0, False)
    assert "fault" not in str(err.value)


@pytest.fixture(scope="module")
def k5_wide():
    """Inputs of the down stack's widest flows at B = 2 (4x4x128 at hid
    256, 4x4x96 at hid 384, 8 conditioning channels, order A and order D),
    and the JAX K5 (``masked_conv_inverse_pallas`` in interpret mode) on
    them, all in one jitted program."""
    from ipoke_tpu.ops.masked_conv import masked_conv_inverse_pallas

    rng = np.random.default_rng(71)
    n = lambda *shape, std=1.0: (std * rng.standard_normal(shape)).astype(np.float32)
    cases = []
    for (c, hid), order in zip(((128, 256), (96, 384)), "AD"):
        ks = (2, 3) if order in "AB" else (3, 2)  # C/D store them swapped
        params = {"w_shift": n(*ks, c, hid, std=(6 * c) ** -0.5),
                  "out": {"v": n(1, 1, hid + 8, 2 * c, std=0.05),
                          "g": n(2 * c, std=0.3), "b": n(2 * c, std=0.1)}}
        v = params["out"]["v"]
        w_out = (v * (params["out"]["g"] / np.sqrt((v * v).sum((0, 1, 2)) + 1e-12)))[0, 0]
        cases.append((order, params, n(2, 4, 4, c), n(2, 4, 4, 8), w_out))

    # fault (e)'s 2x2x512 flow at hid 512, order B, through the JAX
    # package's portable inverse (its K5 branch needs a TPU)
    params = {"w_shift": n(2, 3, 512, 512, std=(6 * 512) ** -0.5),
              "out": {"v": n(1, 1, 512 + 8, 1024, std=0.05),
                      "g": n(1024, std=0.3), "b": n(1024, std=0.1)}}
    cases.append(("B", params, n(2, 2, 2, 512), n(2, 2, 2, 8), None))
    flow = jm.MaskedConvFlow(512, (2, 3), order="B", hidden_channels=512,
                             h_channels=8)

    @jax.jit
    def run(args, big):
        return [masked_conv_inverse_pallas(y, h, w, wo, b, order=o, interpret=True)
                for o, (y, h, w, wo, b) in zip("AD", args)] + [
            flow._inverse_portable(*big)]

    want = run([tuple(map(jnp.asarray, (y, h, p["w_shift"], wo, p["out"]["b"])))
                for _, p, y, h, wo in cases[:2]],
               (jax.tree_util.tree_map(jnp.asarray, params),
                jnp.asarray(cases[2][2]), jnp.asarray(cases[2][3])))
    return cases, want


@pytest.mark.parametrize("i", [0, 1, 2])
def test_k5_wide_plain_matches_pallas(k5_wide, i):
    """K5's plain version (the route of CPU tensors) at the down stack's
    wide flows against the JAX K5, and at fault (e)'s 2x2x512 flow (hid
    512, the streamed instance's shape on the card) against the JAX
    package's portable inverse, within 1e-5."""
    from ipoke_tpu_torch.ops.masked_conv import masked_conv_inverse

    cases, want = k5_wide
    order, params, y, h, _ = cases[i]
    got = masked_conv_inverse(_t(y), _t(h), flow_params(params), order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[i]), rtol=0, atol=1e-5)
