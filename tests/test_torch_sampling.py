"""The port's sampling path (ipoke_tpu_torch) against the JAX package's: module
mappings (transpose conv, resize, spectral norm), the first-stage decode and
the whole ``forward_sample``, with the same weights and inputs, in fp32 on
CPU (where every kernel wrapper takes its plain version)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import __graft_entry__ as ge
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models.first_stage import FirstStageModel as JFirstStage
from ipoke_tpu.models.second_stage import FrozenBundle
from ipoke_tpu.nn import blocks as jb
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import flow_params, load_flax, to_numpy_tree
from ipoke_tpu_torch.data.synthetic import make_batch
from ipoke_tpu_torch.nn import blocks as tb

from test_torch_ops import _few_threads, _np, _t  # noqa: F401 (_few_threads)

K = jax.random.PRNGKey
# every coupling keeps at least one output channel: z_dim 16 under factor 16
TOY = dict(spatial=32, min_spatial=8, T=3, z_dim=16, dec_ch=(32, 16, 8),
           nf_cond=8, num_steps=(2, 1), mid_factor=8, batch_size=2)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


_STD = {"v": 0.05, "g": 0.1, "b": 0.05, "bias": 0.05, "log_scale": 0.05,
        "u": 1.0, "motion_bias": 1.0}


def _fill(tree, rng):
    """numpy values for a tree of ShapeDtypeStructs: fan-in-scaled kernels,
    random permutations, and non-trivial out convs (g != 0) and norms."""
    if isinstance(tree, (list, tuple)):
        return [_fill(v, rng) for v in tree]
    out = {}
    if "buf_perm" in tree:
        shape = tree["buf_perm"].shape
        perm = np.stack([rng.permutation(shape[-1]) for _ in
                         range(int(np.prod(shape[:-1])))]).reshape(shape)
        out["buf_perm"] = perm.astype(np.int32)
        out["buf_inv_perm"] = np.argsort(perm, axis=-1).astype(np.int32)
    for key, v in tree.items():
        if key in out:
            continue
        k = key.rsplit("/", 1)[-1]  # spectral norm stats: "Conv_0/kernel/u"
        if not hasattr(v, "shape"):
            out[key] = _fill(v, rng)
        elif k == "sigma":
            out[key] = np.ones(v.shape, np.float32)
        else:
            noise = rng.standard_normal(v.shape).astype(np.float32)
            if k == "scale":
                out[key] = 1.0 + 0.1 * noise
            elif k in _STD:
                out[key] = _STD[k] * noise
            else:  # HWIO kernels, possibly stacked
                out[key] = noise * np.float32(np.prod(v.shape[-4:-1]) ** -0.5)
    return out


# ---------------------------------------------------------------------------
# module mappings
# ---------------------------------------------------------------------------

def test_conv_transpose_mapping():
    """flax ConvTranspose(k3, s2, SAME) == the port's flipped-kernel
    conv_transpose2d cropped at the end."""
    layer = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
    x = _x((2, 5, 5, 3), 1)
    v = layer.init(K(0), jnp.asarray(x))
    want = layer.apply(v, jnp.asarray(x))
    port = tb.ConvTranspose(3, 4)
    load_flax(port, to_numpy_tree(v["params"]))
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), _np(want),
                               atol=1e-6)


@pytest.mark.parametrize("size", [4, 8, 16, 32, 48])
def test_resize_matches_jax_bilinear(size):
    """jax.image.resize bilinear antialiases when it downscales; so does the
    port's resize."""
    y = _x((2, 32, 32, 3), size)
    want = jax.image.resize(jnp.asarray(y), (2, size, size, 3), "bilinear")
    got = tb.resize_bilinear(_t(y), size, size)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


@pytest.mark.parametrize("kind", ["conv_none", "conv_group", "conv_instance",
                                  "transpose"])
def test_spectral_norm_collapse_matches_flax_eval(kind):
    """A spectral-normed flax block in eval mode == the port's block with the
    collapsed weight (and flax GroupNorm's fast-variance stats).  Non-zero
    biases keep a norm after the conv from hiding the weight's scale."""
    if kind == "transpose":
        jblock = jb.Conv2dTransposeBlock(8, norm="in", snorm=True)
        port = tb.Conv2dTransposeBlock(5, 8, norm="in")
    else:
        norm = kind.split("_")[1].replace("instance", "in")
        jblock = jb.Conv2dBlock(8, 3, 2, 1, norm=norm, snorm=True)
        port = tb.Conv2dBlock(5, 8, 3, 2, 1, norm=norm)
    x = _x((2, 8, 8, 5), 3, 2.0)
    shapes = jax.eval_shape(lambda: jblock.init(K(1), jnp.asarray(x)))
    v = _fill(shapes, np.random.default_rng(7))
    assert "SpectralNorm_0" in v["batch_stats"]
    want = jblock.apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x),
                        train=False)
    load_flax(port, v["params"], v["batch_stats"])
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), _np(want),
                               atol=2e-5)


# ---------------------------------------------------------------------------
# decode and forward_sample at a toy configuration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    """The JAX model and the port's model carrying the same weights (numpy
    values over the JAX init's shapes; the out convs are non-trivial)."""
    cfg = TOY
    s, m = cfg["spatial"], cfg["min_spatial"]
    jmodel, _ = ge._make_models(
        spatial=s, min_spatial=m, T=cfg["T"], z_dim=cfg["z_dim"],
        enc_ch=(16, 16, 32, 32), dec_ch=cfg["dec_ch"], nf_cond=cfg["nf_cond"],
        num_steps=cfg["num_steps"], mid_factor=cfg["mid_factor"])
    rng = np.random.default_rng(4)
    # the motion encoder does not take part in sampling: decode's vars only
    shapes = jax.eval_shape(lambda: {
        "fs": jmodel.first_stage.init(
            {"params": K(0)}, jnp.zeros((1, m, m, cfg["z_dim"])),
            jnp.zeros((1, s, s, 3)), cfg["T"], False, method=JFirstStage.decode),
        "cond": jmodel.conditioner.init({"params": K(2)},
                                        jnp.zeros((1, s, s, 3))),
        "poke": jmodel.poke_embedder.init({"params": K(3)},
                                          jnp.zeros((1, s, s, 2))),
        "flow": jmodel.init(K(4))["flow"],
    })
    values = _fill(shapes, rng)
    frozen = {name: FrozenBundle(
        jax.tree_util.tree_map(jnp.asarray, values[name]["params"]),
        jax.tree_util.tree_map(jnp.asarray, values[name]["batch_stats"]))
        for name in ("fs", "cond", "poke")}
    params = {"flow": jax.tree_util.tree_map(jnp.asarray, values["flow"])}

    port = entry.make_model(cfg, flow_params(values["flow"]))
    for sub, name in ((port.first_stage, "fs"), (port.conditioner, "cond"),
                      (port.poke_embedder, "poke")):
        load_flax(sub, values[name]["params"], values[name]["batch_stats"])
    return jmodel, params, frozen, port.eval()


def test_decode_matches_jax(toy):
    jmodel, _, frozen, port = toy
    cfg = TOY
    m = cfg["min_spatial"]
    motion = _x((2, m, m, cfg["z_dim"]), 10)
    start = _x((2, cfg["spatial"], cfg["spatial"], 3), 11)
    want = jax.jit(lambda f, mo, st: jmodel.decode_first_stage(
        f, mo, st, cfg["T"]))(frozen, jnp.asarray(motion), jnp.asarray(start))
    with torch.no_grad():
        got = port.first_stage.decode(_t(motion), _t(start), cfg["T"])
    assert got.shape == (2, cfg["T"], cfg["spatial"], cfg["spatial"], 3)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-3)


def test_forward_sample_matches_jax(toy):
    """embed_conditioning -> flow.inverse(z) -> decode, same z on both."""
    jmodel, params, frozen, port = toy
    cfg = TOY
    m = cfg["min_spatial"]
    batch_np = jax_make_batch(np.random.default_rng(0), batch_size=2,
                              n_frames=cfg["T"], spatial_size=cfg["spatial"])
    batch_np = {k: batch_np[k] for k in ("images", "poke")}
    z = _x((2, m, m, cfg["z_dim"]), 12)

    @jax.jit
    def jax_sample(params, frozen, batch, z):
        cond = jmodel.embed_conditioning(frozen, batch, params)
        motion = jmodel.flow.inverse(params["flow"], z, cond)
        return jmodel.decode_first_stage(frozen, motion, batch["images"][:, 0],
                                         cfg["T"])

    want = jax_sample(params, frozen,
                      {k: jnp.asarray(v) for k, v in batch_np.items()},
                      jnp.asarray(z))
    got = port.forward_sample({k: _t(v) for k, v in batch_np.items()},
                              cfg["T"], z=_t(z))
    assert got.shape == (2, cfg["T"], cfg["spatial"], cfg["spatial"], 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-3)


def test_make_batch_matches_jax_package():
    want = jax_make_batch(np.random.default_rng(5), batch_size=3, n_frames=4,
                          spatial_size=32)
    got = make_batch(np.random.default_rng(5), batch_size=3, n_frames=4,
                     spatial_size=32)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax, flax, optax or
    ipoke_tpu module."""
    code = (
        "import importlib, pkgutil, sys, ipoke_tpu_torch\n"
        "for m in pkgutil.walk_packages(ipoke_tpu_torch.__path__, "
        "'ipoke_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ipoke_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
