"""The dormant zoo and the Human3.6m helper against the JAX package:
``flows/extra.py`` (MixCDF, the hierarchical coupling flow, MADE, the
gated conv and attention), ``flows/leapfrog.py``, ``nn/motion_generator.py``,
``AdaIN``, ``MinibatchDiscrimination`` and ``data/human36m_preprocess.py``.

Every JAX reference comes from the file's one jitted program
(``jax_ref``), on flow trees from the port's own inits and flax variables
drawn at their init's shapes; the params reach the port through
``convert.flow_params`` (flow trees) and ``convert.load_flax`` (flax
nets).  fp32 throughout; the tolerances are stated per test.
"""

import io
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.data import human36m_preprocess as jh36m
from ipoke_tpu.flows import extra as jx
from ipoke_tpu.flows import leapfrog as jl
from ipoke_tpu.nn.blocks import AdaIN as JAdaIN
from ipoke_tpu.nn.discriminators import MinibatchDiscrimination as JMBD
from ipoke_tpu.nn.motion_generator import Generator3D as JGenerator3D
from ipoke_tpu_torch.convert import flow_params, load_flax, to_numpy_tree
from ipoke_tpu_torch.data import human36m_preprocess as th36m
from ipoke_tpu_torch.flows import extra as tx
from ipoke_tpu_torch.flows import leapfrog as tl
from ipoke_tpu_torch.nn.blocks import AdaIN
from ipoke_tpu_torch.nn.discriminators import MinibatchDiscrimination
from ipoke_tpu_torch.nn.motion_generator import Generator3D

from test_torch_ops import _few_threads  # noqa: F401 (a module fixture)

K = jax.random.PRNGKey
_RNG = np.random.default_rng(0)


def _n(*shape, std=1.0):
    return (std * _RNG.standard_normal(shape)).astype(np.float32)


X_MIX, X_HIER, H_HIER = _n(2, 4, 4, 6), _n(2, 4, 4, 8), _n(2, 4, 4, 4)
X_MADE, Y_MADE = _n(3, 5), _n(3, 3)
X_GATED, XC_GATED = _n(2, 4, 4, 6), _n(2, 4, 4, 4)
X_LEAP, V_LEAP = _n(4, 6), _n(4, 6)
X_ADAIN, Z_ADAIN = _n(2, 3, 4, 4, 6), _n(2, 8)
Z_GEN, F_GEN = _n(2, 8), _n(2, 16, 16, 3)
X_MBD = _n(4, 6)

MIX = jx.MixCDFCoupling(6, hidden_channels=8, components=3)
MIX_STACK = jx.build_mixcdf_flow(6, n_blocks=2, hidden_channels=8, components=2)
HIER = jx.HierarchicalCouplingFlow(num_steps=(1, 1), in_channels=8, hidden_channels=16,
                                   h_channels=4, factor=4, n_blocks=1)
MADE = jx.MADE(nin=5, hidden_sizes=(16, 16), nout=10, ncond=3)
GATED = (jx.GatedConv2d(dim=6, dim_cond=4), jx.GatedConv2d(dim=6, dim_out=10))
ATTN = jx.GatedAttention(channels=6, heads=2)
LEAPS = {e: jl.LeapFlow(in_channels=6, hidden_dim=16, depth=1, n_flows=3, delta_t=0.7,
                        extended=e) for e in (False, True)}
GEN = dict(nf=4, z_dim=8, spatial_size=16, max_frames=4)


def _port_tree(flow, seed, *extra):
    """A flow's tree from the port's own init (JAX's inits are the file's
    slowest trace), every weight-norm conv's g drawn at 0.3 (init leaves a
    coupling's at 0: an identity), as numpy for both packages."""
    gen = torch.Generator().manual_seed(seed)
    tree = to_numpy_tree(flow.init(gen, "cpu", *extra))
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if {"v", "g", "b"} <= node.keys():
                node["g"] = (0.3 * rng.standard_normal(node["g"].shape)).astype(np.float32)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(tree)
    return tree


def _flax_vars(module, seed, *args):
    """A flax module's variables drawn with numpy at its init's shapes
    (``jax.eval_shape``: no trace of the init is compiled): kernels and
    ``T`` at 1/sqrt(fan-in), biases at 0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(K(0), *args))

    def draw(path, sds):
        name = str(getattr(path[-1], "key", path[-1]))
        std = 0.1 if name == "bias" else float(np.prod(sds.shape[:-1])) ** -0.5
        return (std * rng.standard_normal(sds.shape)).astype(np.float32)

    return to_numpy_tree(jax.tree_util.tree_map_with_path(draw, shapes))


PORT = {"mix": tx.MixCDFCoupling(6, hidden_channels=8, components=3),
        "mix_stack": tx.build_mixcdf_flow(6, n_blocks=2, hidden_channels=8, components=2),
        "hier": tx.HierarchicalCouplingFlow(num_steps=(1, 1), in_channels=8,
                                            hidden_channels=16, h_channels=4,
                                            factor=4, n_blocks=1),
        "made": tx.MADE(nin=5, hidden_sizes=(16, 16), nout=10, ncond=3),
        "gated0": tx.GatedConv2d(dim=6, dim_cond=4),
        "gated1": tx.GatedConv2d(dim=6, dim_out=10),
        "leap0": tl.LeapFlow(in_channels=6, hidden_dim=16, depth=1, n_flows=3,
                             delta_t=0.7, extended=False),
        "leap1": tl.LeapFlow(in_channels=6, hidden_dim=16, depth=1, n_flows=3,
                             delta_t=0.7, extended=True)}


@pytest.fixture(scope="module")
def jax_ref():
    """Params and outputs of every JAX module here, one jitted program:
    the flows' trees from the port's inits, the flax nets' variables drawn
    at their shapes."""
    params = {name: _port_tree(flow, i) for i, (name, flow) in enumerate(PORT.items())}
    params["attn"] = _port_tree(tx.GatedAttention(channels=6, heads=2), 9, (4, 4))
    gen, ada, mbd = JGenerator3D(**GEN), JAdaIN(6), JMBD(6, 4, 3)
    params["gen"] = _flax_vars(gen, 10, Z_GEN, F_GEN)
    params["adain"] = _flax_vars(ada, 11, X_ADAIN, Z_ADAIN)
    params["mbd"] = _flax_vars(mbd, 12, X_MBD)

    @jax.jit
    def run(p):
        out = {}
        for name, flow in (("mix", MIX), ("mix_stack", MIX_STACK)):
            y, ld = flow.forward(p[name], X_MIX)
            out[name] = (y, ld, flow.inverse(p[name], y))
        y, ld = HIER.forward(p["hier"], X_HIER, H_HIER)
        out["hier"] = (y, ld, HIER.inverse(p["hier"], y, H_HIER))
        out["made"] = MADE.apply(p["made"], X_MADE, Y_MADE)
        out["gated"] = (GATED[0].apply(p["gated0"], X_GATED, XC_GATED),
                        GATED[1].apply(p["gated1"], X_GATED), ATTN.apply(p["attn"], X_GATED))
        for e, flow in LEAPS.items():
            y, w, ld = flow.forward(p[f"leap{int(e)}"], X_LEAP, V_LEAP)
            out[f"leap{int(e)}"] = (y, w, ld, flow.inverse(p[f"leap{int(e)}"], y, w))
        out["adain"] = ada.apply(p["adain"], X_ADAIN, Z_ADAIN)
        out["gen"] = gen.apply(p["gen"], Z_GEN, F_GEN)
        out["mbd"] = (mbd.apply(p["mbd"], X_MBD),
                      mbd.apply(p["mbd"], jnp.broadcast_to(X_MBD[:1], X_MBD.shape)))
        return out

    return params, to_numpy_tree(run(params))


def _t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["mix", "mix_stack", "hier"])
def test_coupling_flows_match_jax(jax_ref, name):
    """``MixCDFCoupling`` (K = 3), ``build_mixcdf_flow`` (2 blocks) and
    ``HierarchicalCouplingFlow`` (2 levels, conditioned) on the same tree:
    forward and logdet within 1e-4 (of max |logdet| past 1), the inverse
    of JAX's output (the MixCDF inverse is a 50-step bisection in both)
    within 1e-4 of JAX's, and the port's round trip within 5e-3 (the JAX
    tests' bisection tolerance)."""
    params, out = jax_ref
    flow = PORT[name]
    y, ld, x_back = out[name]
    x, h = (X_HIER, _t(H_HIER)) if name == "hier" else (X_MIX, None)
    tree = flow_params(params[name])
    got_y, got_ld = flow.forward(tree, _t(x), h)
    close(got_y, y, 1e-4)
    close(got_ld, ld, 1e-4 * max(1.0, float(np.abs(ld).max())))
    close(flow.inverse(tree, _t(y), h), x_back, 1e-4)
    close(flow.inverse(tree, got_y, h), x, 5e-3)


def test_mixture_functions_match_jax():
    """``mixlogcdf``, ``mixlogpdf_log`` and the bisection inverse,
    elementwise, against the JAX functions run eagerly."""
    x, logits, means, ls = _n(3, 5), _n(3, 5, 4), _n(3, 5, 4), _n(3, 5, 4, std=0.3)
    want = [np.asarray(f(x, logits, means, ls)) for f in (jx.mixlogcdf, jx.mixlogpdf_log)]
    got = [f(*map(_t, (x, logits, means, ls))) for f in (tx.mixlogcdf, tx.mixlogpdf_log)]
    close(got[0], want[0], 1e-6)
    close(got[1], want[1], 1e-5)
    close(tx._inv_mixlogcdf(got[0], *map(_t, (logits, means, ls))), x, 1e-4)


def test_made_masks_bitwise_and_apply_matches_jax(jax_ref):
    """MADE's masks equal the JAX package's bit for bit (numpy's draw from
    the same seed, natural and permuted orderings); the conditioned MADE
    on the same tree within 1e-5."""
    for order in (True, False):
        for got, want in zip(tx.made_masks(5, [16, 16], 10, 3, order),
                             jx.made_masks(5, [16, 16], 10, 3, order)):
            assert np.array_equal(got.numpy(), np.asarray(want))
    params, out = jax_ref
    close(PORT["made"].apply(flow_params(params["made"]), _t(X_MADE), _t(Y_MADE)),
          out["made"], 1e-5)


def test_made_autoregressive_property():
    """Output chunk j is independent of inputs >= j (natural ordering), the
    JAX test's property, on the port's own init."""
    made = tx.MADE(nin=5, hidden_sizes=(16, 16), nout=10)
    params = made.init(torch.Generator().manual_seed(0), "cpu")
    jac = torch.autograd.functional.jacobian(
        lambda a: made.apply(params, a[None])[0], _t(X_MADE[0]))
    for chunk in jac.reshape(2, 5, 5):
        for j in range(5):
            assert torch.all(chunk[j, j:] == 0), j


def test_gated_conv_and_attention_match_jax(jax_ref):
    """``GatedConv2d`` with a conditioning input, with ``dim_out``, and
    ``GatedAttention`` (2 heads over 4x4 tokens) on the same trees within
    1e-5."""
    params, out = jax_ref
    o1, o2, o3 = out["gated"]
    x = _t(X_GATED)
    close(PORT["gated0"].apply(flow_params(params["gated0"]), x, _t(XC_GATED)), o1, 1e-5)
    close(PORT["gated1"].apply(flow_params(params["gated1"]), x), o2, 1e-5)
    close(tx.GatedAttention(channels=6, heads=2).apply(flow_params(params["attn"]), x),
          o3, 1e-5)


@pytest.mark.parametrize("extended", [False, True])
def test_leapflow_matches_jax(jax_ref, extended):
    """``LeapFlow`` of 3 blocks (leapfrog and extended couplings) on the
    same stacked tree: forward (x, v, logdet) and the inverse of JAX's
    output within 1e-5 (of max |logdet| past 1), and the port's round trip
    within 2e-4 (the JAX test's)."""
    params, out = jax_ref
    y, w, ld, back = out[f"leap{int(extended)}"]
    flow = PORT[f"leap{int(extended)}"]
    tree = flow_params(params[f"leap{int(extended)}"])
    gy, gw, gld = flow.forward(tree, _t(X_LEAP), _t(V_LEAP))
    for got, want in ((gy, y), (gw, w), (gld, ld)):
        close(got, want, 1e-5 * max(1.0, float(np.abs(want).max())))
    bx, bv = flow.inverse(tree, _t(y), _t(w))
    close(bx, back[0], 1e-5)
    close(bv, back[1], 1e-5)
    rx, rv = flow.inverse(tree, gy, gw)
    close(rx, X_LEAP, 2e-4)
    close(rv, V_LEAP, 2e-4)


def test_extended_leapfrog_logdet_matches_autodiff():
    """The extended coupling's logdet against log|det| of the Jacobian of
    the joint map (x, v) -> (y, w), in float64 on the port's own init (the
    JAX test's property), within 1e-4."""
    c = tl.ExtendedLeapFrogCoupling(4, 12, depth=1, delta_t=0.5)
    params = flow_params(to_numpy_tree(c.init(torch.Generator().manual_seed(1), "cpu")),
                         dtype=torch.float64)
    xv = _t(_n(8)).double()

    def joint(zz):
        y, w, _ = c.forward(params, zz[None, :4], zz[None, 4:])
        return torch.cat([y[0], w[0]])

    _, logabs = torch.linalg.slogdet(torch.autograd.functional.jacobian(joint, xv))
    _, _, ld = c.forward(params, xv[None, :4], xv[None, 4:])
    assert abs(float(ld[0]) - float(logabs)) < 1e-4


def test_adain_matches_flax(jax_ref):
    """``AdaIN`` over (B, T, H, W, C) from flax's variables within 1e-5."""
    params, out = jax_ref
    net = AdaIN(6, 8)
    load_flax(net, params["adain"]["params"])
    close(net(_t(X_ADAIN), _t(Z_ADAIN)), out["adain"], 1e-5)


def test_generator3d_matches_flax(jax_ref):
    """``Generator3D`` (nf 4, 16 px, 4 frames: two up-blocks, each doubling
    T; the start frame resized down for the first) from flax's variables
    through ``load_flax`` within 1e-4."""
    params, out = jax_ref
    net = Generator3D(**GEN)
    load_flax(net, params["gen"]["params"])
    got = net(_t(Z_GEN), _t(F_GEN))
    assert got.shape == (2, 4, 16, 16, 3)
    close(got, out["gen"], 1e-4)


def test_minibatch_discrimination_matches_flax(jax_ref):
    """``MinibatchDiscrimination`` from flax's ``T`` within 1e-5 on a
    diverse batch and on a collapsed one, where every feature is exp(0)
    times B - 1 = 3.0 (the JAX test's property)."""
    params, out = jax_ref
    want, want_c = out["mbd"]
    net = MinibatchDiscrimination(6, 4, 3)
    load_flax(net, params["mbd"]["params"])
    x = _t(X_MBD)
    with torch.no_grad():
        got, got_c = net(x), net(x[:1].expand(4, 6))
    close(got, want, 1e-5)
    close(got_c, want_c, 1e-5)
    close(got_c[:, 6:], np.full((4, 4), 3.0, np.float32), 1e-5)
    assert float(got_c[:, 6:].mean()) > float(got[:, 6:].mean())


def test_zoo_inits_match_jax_trees():
    """The port's own inits give the JAX inits' trees (structure and
    shapes, by ``jax.eval_shape``), so weights carry across either way."""
    shapes = lambda t: [tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(t)]
    jax_inits = {"mix": lambda: MIX.init(K(0)), "mix_stack": lambda: MIX_STACK.init(K(0), 0),
                 "hier": lambda: HIER.init(K(0), 0), "made": lambda: MADE.init(K(0)),
                 "gated0": lambda: GATED[0].init(K(0)), "gated1": lambda: GATED[1].init(K(0)),
                 "leap0": lambda: LEAPS[False].init(K(0)),
                 "leap1": lambda: LEAPS[True].init(K(0))}
    gen = torch.Generator().manual_seed(0)
    for name, init in jax_inits.items():
        ours = to_numpy_tree(PORT[name].init(gen, "cpu"))
        assert shapes(ours) == shapes(jax.eval_shape(init)), name
    attn = tx.GatedAttention(channels=6, heads=2).init(gen, "cpu", (4, 4))
    assert shapes(to_numpy_tree(attn)) == shapes(jax.eval_shape(lambda: ATTN.init(K(0), (4, 4))))


def test_human36m_helpers_match_jax(tmp_path):
    """The subjects, ``extract`` of a tarball and ``list_videos`` of the
    tree, against the JAX package's (the downloader is not called)."""
    assert th36m.SUBJECTS == jh36m.SUBJECTS and th36m.BASE_URL == jh36m.BASE_URL
    tgz = tmp_path / "S1.tgz"
    with tarfile.open(tgz, "w:gz") as tf:
        for name in ("S1/Videos/a.mp4", "S1/Videos/b.mp4", "S1/readme.txt"):
            data = name.encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    for mod, out in ((th36m, tmp_path / "port"), (jh36m, tmp_path / "jax")):
        mod.extract(str(tgz), str(out))
    got = [os.path.relpath(p, tmp_path / "port") for p in th36m.list_videos(str(tmp_path / "port"))]
    want = [os.path.relpath(p, tmp_path / "jax") for p in jh36m.list_videos(str(tmp_path / "jax"))]
    assert got == want == ["S1/Videos/a.mp4", "S1/Videos/b.mp4"]
