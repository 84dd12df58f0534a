"""The paper's PyTorch checkpoints in the port: a reference-layout state dict
drawn from a seed goes through the JAX package's tools
(``tools/port_reference_*``) into the JAX models built with
``torch_compat=True``, and through ``ipoke_tpu_torch.reference`` into the
port; the two compute the same function (fp32, CPU).  Also the transposed
convs of every ``ks``/``st`` against flax and torch, the align-corners
resize, ``motion_bias: false`` and a run written by ``reference.write_run``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ipoke_tpu.core.config import Config as JConfig
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models.first_stage import FirstStageModel as JFirstStage
from ipoke_tpu.models.second_stage import FrozenBundle, SecondStageModel as JSecondStage
from ipoke_tpu.nn import blocks as jb
from ipoke_tpu.nn.encoders import FirstStageWrapper as JWrapper
from ipoke_tpu.nn.gru import ConvGRU as JConvGRU
from ipoke_tpu_torch import entry, reference
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.nn import blocks as tb
from tools.port_reference_encoders import port_conv_encoder, port_first_stage
from tools.port_reference_flow import port_multiscale_state

from test_torch_ops import _few_threads, _np, _t  # noqa: F401 (_few_threads)

K = jax.random.PRNGKey
# 64 px (three up blocks from 8x8), a two-level cINN; z_dim 16 under factor 16
REF = dict(spatial=64, min_spatial=8, T=3, z_dim=16, enc_ch=(16, 16, 32, 32),
           dec_ch=(32, 16, 8, 8), nf_cond=8, num_steps=(2, 1), mid_factor=4,
           batch_size=2, torch_compat=True)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form,ks,st", [
    ("torch", 3, 2), ("same", 3, 2), ("same", 4, 2), ("same", 2, 2),
    ("same", 3, 1), ("same", 2, 3), ("same", 5, 3), ("crop", 4, 2)])
def test_transpose_conv(form, ks, st):
    """``torch``: the port's ``torch_crop`` form against torch's own
    ``ConvTranspose2d(k3, s2, p=1, output_padding=1)`` on the same reference
    weights (transposed into flax's layout and back by the loader); ``same``:
    the default form against flax's ``ConvTranspose(ks, st, "SAME")``;
    ``crop``: ``torch_crop`` against flax's ``"VALID"`` with
    ``transpose_kernel=True`` then ``[1:, 1:]``."""
    x = _x((2, 5, 5, 3), ks * 10 + st, 1.5)
    port = tb.ConvTranspose(3, 4, ks, st, torch_crop=form != "same")
    if form == "torch":
        ref = torch.nn.ConvTranspose2d(3, 4, 3, 2, padding=1, output_padding=1)
        with torch.no_grad():
            ref.bias.normal_(0, 0.1)
            want = ref(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        kernel = reference._convT_w(ref.weight.detach().numpy())
        load_flax(port, {"kernel": kernel, "bias": ref.bias.detach().numpy()})
    else:
        layer = fnn.ConvTranspose(4, (ks, ks), strides=(st, st),
                                  padding="SAME" if form == "same" else "VALID",
                                  transpose_kernel=form == "crop")
        kshape = (ks, ks, 4, 3) if form == "crop" else (ks, ks, 3, 4)
        v = {"params": {"kernel": jnp.asarray(_x(kshape, ks, 0.3)),
                        "bias": 0.1 * jnp.asarray(_x((4,), st))}}
        want = _np(layer.apply(v, jnp.asarray(x)))
        if form == "crop":
            want = want[:, 1:, 1:]
        load_flax(port, {k: np.asarray(a) for k, a in v["params"].items()})
    got = port(_t(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("size", [4, 16, 48])
def test_resize_align_corners(size):
    y = _x((2, 16, 16, 3), size)
    want = jb.resize_bilinear_align_corners(jnp.asarray(y), size, size)
    got = tb.resize_bilinear_align_corners(_t(y), size, size)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_checkpoint_prefixes_stripped(tmp_path):
    """A Lightning ``.ckpt`` (``state_dict`` under ``model.``) reads back as
    the state it holds, as the JAX package's ``convert`` strips it."""
    state = {"a.weight": _x((2, 3), 0), "module.b.bias": _x((4,), 1),
             "c.forward_shuffle_idx": np.arange(5)}
    reference.save_ckpt(state, str(tmp_path / "x.ckpt"))
    got = reference.read_state(str(tmp_path / "x.ckpt"))
    assert set(got) == {"a.weight", "b.bias", "c.forward_shuffle_idx"}
    np.testing.assert_array_equal(got["b.bias"], state["module.b.bias"])
    reference.dump(str(tmp_path / "x.ckpt"), str(tmp_path / "x.npz"))
    again = reference.read_state(str(tmp_path / "x.npz"))
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


# ---------------------------------------------------------------------------
# a reference-layout state through both packages
# ---------------------------------------------------------------------------

def _jax_models(cfg, torch_compat=True, motion_bias=True):
    s, m = cfg["spatial"], cfg["min_spatial"]
    fs = JFirstStage(spatial_size=s, z_dim=cfg["z_dim"],
                     enc_channels=cfg["enc_ch"], dec_channels=cfg["dec_ch"],
                     n_gru_layers=2, min_spatial_size=m, max_frames=cfg["T"],
                     use_motion_bias=motion_bias, deterministic=True,
                     spectral_norm=False, torch_compat=torch_compat)
    cond, poke = (JWrapper(spatial_size=s, nf_in=c, nf_max=cfg["nf_cond"],
                           min_spatial_size=m, snorm=False, deterministic=True)
                  for c in (3, 2))
    ss_cfg = JConfig({
        "data": {"spatial_size": (s, s), "max_frames": cfg["T"]},
        "architecture": {"flow_mid_channels_factor": cfg["mid_factor"],
                         "factor": 16, "num_steps": list(cfg["num_steps"]),
                         "kernel_size": [2, 3], "transform": "affine",
                         "prior_transform": "affine", "activation": "elu",
                         "augmented_input": False},
        "training": {"spatial_mean": False}, "poke_embedder": {}})
    return JSecondStage(ss_cfg, fs, cond, poke)


def _port_model(cfg, **kw):
    cfg = dict(cfg, **kw)
    with torch.device("meta"):
        model = entry.make_model(cfg)
    model = model.to_empty(device="cpu")
    model.flow_params = entry.ParamTree(model.init_params(torch.Generator(), "cpu"))
    return model.eval()


@pytest.fixture(scope="module")
def ref():
    """The reference states, their JAX trees (the tools) and the port model
    loaded through ``reference.load_second_stage``."""
    cfg = REF
    port = _port_model(cfg, deterministic=True)
    states = reference.draw_second_stage(port, seed=3)
    reference.load_second_stage(port, states["first_stage"], states["conditioner"],
                                states["poke_embedder"], states["flow"])
    n_stages = port.conditioner.encoder.n_res
    trees = {
        "fs": port_first_stage(states["first_stage"], 2, len(cfg["dec_ch"]) - 1),
        "cond": {"encoder": port_conv_encoder(states["conditioner"], n_stages)},
        "poke": {"encoder": port_conv_encoder(states["poke_embedder"], n_stages)},
        "flow": port_multiscale_state(states["flow"], cfg["num_steps"]),
    }
    return states, _j(trees), port


def _flax_layout(tree):
    """The tree with every transposed conv's kernel (kh, kw, out, in) as the
    package's own transposed convs take it, (kh, kw, in, out)."""
    if isinstance(tree, dict):
        return {k: (dict(v, kernel=np.swapaxes(v["kernel"], 2, 3))
                    if k == "ConvTranspose_0" else _flax_layout(v))
                for k, v in tree.items()}
    return tree


# motion_bias: false at 32 px
NO_BIAS = dict(REF, spatial=32, dec_ch=(32, 8, 8))


@pytest.fixture(scope="module")
def no_bias():
    """A first stage without ``motion_bias`` loaded from its reference state,
    and the JAX tree of that state (the JAX tool reads a motion bias; the
    model without one has no such leaf)."""
    cfg = NO_BIAS
    fs = entry._fs.FirstStageModel(
        32, z_dim=cfg["z_dim"], dec_channels=cfg["dec_ch"], n_gru_layers=2,
        min_spatial_size=8, enc_channels=cfg["enc_ch"], max_frames=cfg["T"],
        use_motion_bias=False, torch_compat=True)
    state = reference.draw_first_stage(fs, np.random.default_rng(2))
    reference.load_first_stage(fs, state)
    tree = port_first_stage(dict(state, motion_bias=np.zeros((1, 16, 8, 8))), 2, 2)
    return state, fs.eval(), {k: v for k, v in tree.items() if k != "motion_bias"}


@pytest.fixture(scope="module")
def jax_outputs(ref, no_bias):
    """The JAX side of every comparison below, in one jitted program: the
    motion encoder's mu, both conv encoders, a ConvGRU step, the decode at 64 px with
    ``torch_compat`` on and off (the package's own semantics on the same
    numbers, its transposed kernels in its layout) and without
    ``motion_bias``, the cINN's forward (z, logdet) and inverse on the
    conditioning, and ``forward_sample``'s video from a given z."""
    states, trees, _ = ref
    cfg, s, m, T = REF, REF["spatial"], REF["min_spatial"], REF["T"]
    jmodel, joff = _jax_models(cfg), _jax_models(cfg, torch_compat=False)
    jnb = _jax_models(NO_BIAS, motion_bias=False).first_stage
    off = _j(_flax_layout(port_first_stage(states["first_stage"], 2,
                                           len(cfg["dec_ch"]) - 1)))
    frozen = {k: FrozenBundle(trees[k], {}) for k in ("fs", "cond", "poke")}
    batch = jax_make_batch(np.random.default_rng(0), batch_size=2,
                           n_frames=T, spatial_size=s)
    inputs = {"batch": {k: batch[k] for k in ("images", "poke")},
              "X": _x((2, T + 1, s, s, 3), 5), "cond": _x((2, s, s, 3), 9),
              "poke": _x((2, s, s, 2), 8), "motion": _x((2, m, m, cfg["z_dim"]), 10),
              "start": _x((2, s, s, 3), 11), "start32": _x((2, 32, 32, 3), 13),
              "x": _x((2, m, m, cfg["z_dim"]), 14), "z": _x((2, m, m, cfg["z_dim"]), 15)}

    @jax.jit
    def run(trees, off, nb, frozen, i):
        fs = {"params": trees["fs"]}
        out = {"mu": jmodel.first_stage.apply(fs, i["X"], method=JFirstStage.encode)[1]}
        for name in ("cond", "poke"):
            out[name] = jmodel.conditioner.apply({"params": trees[name]}, i[name],
                                                 method=JWrapper.encode)[0]
        out["gru"] = JConvGRU(hidden_size=cfg["z_dim"], n_layers=2).apply(
            {"params": trees["fs"]["rnn"]}, i["x"], (i["motion"], i["z"]))
        out["decode_on"] = jmodel.first_stage.apply(
            fs, i["motion"], i["start"], T, False, method=JFirstStage.decode)
        out["decode_off"] = joff.first_stage.apply(
            {"params": off}, i["motion"], i["start"], T, False,
            method=JFirstStage.decode)
        out["decode_no_bias"] = jnb.apply({"params": nb}, i["motion"], i["start32"],
                                          T, False, method=JFirstStage.decode)
        flow = trees["flow"]
        cond = jmodel.embed_conditioning(frozen, i["batch"], {"flow": flow})
        out["z"], out["logdet"] = jmodel.flow.forward(flow, i["x"], cond)
        out["inv"] = jmodel.flow.inverse(flow, out["z"], cond)
        motion = jmodel.flow.inverse(flow, i["z"], cond)
        out["video"] = jmodel.decode_first_stage(frozen, motion,
                                                 i["batch"]["images"][:, 0], T)
        return out

    out = run(trees, off, _j(no_bias[2]), frozen, _j(inputs))
    return inputs, jax.tree_util.tree_map(_np, out)


def test_motion_encoder_conv_encoder_and_gru(ref, jax_outputs):
    """The motion encoder's mu, both conv encoders and one ConvGRU step
    from two hidden states, 1e-4."""
    _, _, port = ref
    i, want = jax_outputs
    with torch.no_grad():
        got = port.first_stage.encode(_t(i["X"]))[1]
        np.testing.assert_allclose(got.numpy(), want["mu"], atol=1e-4, rtol=1e-4)
        got = port.first_stage.rnn(_t(i["x"]), (_t(i["motion"]), _t(i["z"])))
        for a, b in zip(got, want["gru"]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4)
        for name, net in (("cond", port.conditioner), ("poke", port.poke_embedder)):
            got = net.encode(_t(i[name]))[0]
            np.testing.assert_allclose(got.numpy(), want[name], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("torch_compat", [True, False])
def test_decode_matches_jax(ref, jax_outputs, torch_compat):
    """The ConvGRU rollout and the SPADE decode at 64 px, 1e-4:
    ``torch_compat`` on, from the reference weights (the reference's
    semantics), and off, the package's own semantics on the same numbers."""
    states, _, port = ref
    i, want = jax_outputs
    cfg = REF
    fs = port.first_stage
    if not torch_compat:
        fs = _port_model(cfg, torch_compat=False).first_stage
        load_flax(fs, _flax_layout(port_first_stage(states["first_stage"], 2,
                                                    len(cfg["dec_ch"]) - 1)))
    with torch.no_grad():
        got = fs.decode(_t(i["motion"]), _t(i["start"]), cfg["T"])
    assert got.shape == (2, cfg["T"], cfg["spatial"], cfg["spatial"], 3)
    np.testing.assert_allclose(got.numpy(), want["decode_on" if torch_compat
                                                  else "decode_off"],
                               atol=1e-4, rtol=1e-4)


def test_motion_bias_false_matches_jax(ref, no_bias, jax_outputs):
    """``motion_bias: false``: the ConvGRU's input is the motion latent; the
    reference state has no ``motion_bias`` and the loader checks that the
    architecture agrees."""
    state, fs, _ = no_bias
    assert "motion_bias" not in state and fs.motion_bias is None
    with pytest.raises(ValueError, match="motion_bias"):
        reference.load_first_stage(ref[2].first_stage, state)
    i, want = jax_outputs
    with torch.no_grad():
        got = fs.decode(_t(i["motion"]), _t(i["start32"]), NO_BIAS["T"])
    np.testing.assert_allclose(got.numpy(), want["decode_no_bias"], atol=1e-4,
                               rtol=1e-4)


def test_flow_forward_inverse_logdet(ref, jax_outputs):
    _, _, port = ref
    i, want = jax_outputs
    with torch.no_grad():
        cond = port.embed_conditioning({k: _t(v) for k, v in i["batch"].items()})
        got_z, got_logdet = port.flow.forward(port.flow_tree(), _t(i["x"]), cond)
        got_inv = port.flow.inverse(port.flow_tree(), got_z, cond)
    np.testing.assert_allclose(got_z.numpy(), want["z"], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_logdet.numpy(), want["logdet"], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_inv.numpy(), want["inv"], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_inv.numpy(), i["x"], atol=2e-4)


def test_forward_sample_matches_jax(ref, jax_outputs):
    _, _, port = ref
    i, want = jax_outputs
    got = port.forward_sample({k: _t(v) for k, v in i["batch"].items()}, REF["T"],
                              z=_t(i["z"]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want["video"], atol=2e-3)


def test_written_run_loads_as_the_state(ref, tmp_path):
    """``reference.write_run`` (the ``port`` command) writes frozen runs and
    a second-stage run without optimizer state; the CLI's frozen loader and
    the experiment's restore give back the loaded model's weights bit for
    bit and its ``forward_sample`` within fp32 rounding (the nets are built
    by another route, their convs may take other algorithms)."""
    from ipoke_tpu_torch.cli.experiments import SecondStageExperiment, load_frozen
    from ipoke_tpu_torch.core.checkpoint import CheckpointStore
    from ipoke_tpu_torch.core.config import load_config
    from ipoke_tpu_torch.models.second_stage import SecondStageModel

    states, _, port = ref
    cfg = REF
    s, m = cfg["spatial"], cfg["min_spatial"]
    fs_cfg = {"data": {"spatial_size": [s, s], "max_frames": cfg["T"]},
              "architecture": {"z_dim": cfg["z_dim"], "ENC_M_channels": list(cfg["enc_ch"]),
                               "dec_channels": list(cfg["dec_ch"]), "n_gru_layers": 2,
                               "min_spatial_size": m, "deterministic": True},
              "training": {}, "d_s": {}, "d_t": {}}
    ae_cfg = {"data": {"spatial_size": [s, s]},
              "architecture": {"nf_max": cfg["nf_cond"], "min_spatial_size": m}}
    config = {"general": {"experiment": "second_stage"},
              "data": {"spatial_size": [s, s], "max_frames": cfg["T"]},
              "architecture": entry.second_stage_config(cfg)["architecture"],
              "training": {"spatial_mean": False},
              "first_stage": {"config": fs_cfg},
              "conditioner": {"use": True, "config": dict(ae_cfg)},
              "poke_embedder": {"config": {**ae_cfg, "architecture": dict(
                  ae_cfg["architecture"], nf_in=2)}}}
    path = reference.write_run(config, str(tmp_path), "ref", states)
    run_cfg = load_config(path)
    assert run_cfg.get_path("first_stage.config.architecture.torch_compat") is True
    model = SecondStageModel(run_cfg, *load_frozen(run_cfg, torch.Generator().manual_seed(9)))
    model.flow_params = entry.ParamTree(model.init_params(torch.Generator(), "cpu"))
    state = CheckpointStore(str(tmp_path / "second_stage/ckpt/ref/0")).restore()
    assert state["tx"] is None and state["step"] == 0

    class Stub(SecondStageExperiment):  # the restore path without a data tree
        def __init__(self):
            import logging
            self.model, self.logger = model, logging.getLogger("test")
            self.trainer = types.SimpleNamespace(tx=None)

    Stub().load_checkpoint_state(state)
    batch = jax_make_batch(np.random.default_rng(1), batch_size=2,
                           n_frames=cfg["T"], spatial_size=s)
    batch = {k: _t(batch[k]) for k in ("images", "poke")}
    z = _t(_x((2, m, m, cfg["z_dim"]), 16))
    want = port.forward_sample(batch, cfg["T"], z=z)
    got = model.forward_sample(batch, cfg["T"], z=z)
    for name in ("first_stage", "conditioner", "poke_embedder"):
        want_sd, got_sd = getattr(port, name).state_dict(), getattr(model, name).state_dict()
        for k, v in want_sd.items():
            torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0)
    for a, b in zip(model.flow_params.parameters(), port.flow_params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
