"""The port's conv third stage (ipoke_tpu_torch) against the JAX package's,
on CPU in fp32 at the sizes of ``tests/test_third_stage.py`` (the flow VAE:
32 px, 4 latent channels, nf_max 16; the bridge: one level of one step,
factor 4) over ``tests/test_second_stage.py``'s SS_CFG with a deterministic
first stage (``entry.FLOW_MOTION_TINY``), with the same weights (carried by
``convert``), inputs from numpy seeds, and the JAX functions' own random
draws handed to the port as tensors.  Tolerances:

* the bridge's forward (and logdet) and inverse, unconditioned: 2e-4;
* hallucinated flow and video from flow: 2e-3 on the outputs.

The JAX side is one jitted program (``jax_ref``), most of the file's time.
The bridge's train step is held in ``tests/test_torch_third_stage_train.py``
(which shares this file's weights, ``tiny``) and the flow VAE in
``tests/test_torch_flow_vae.py``: one JAX program a file, so that each
file stays within ~30 s and the test workers may compile them at once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.eval import metrics as jmetrics
from ipoke_tpu.models import third_stage as jts
from ipoke_tpu.models.second_stage import FrozenBundle
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import flow_params, load_flax
from ipoke_tpu_torch.eval import angular_error, endpoint_error
from ipoke_tpu_torch.models import third_stage as tts

from test_torch_ops import _jnp, _np, _t
from test_torch_sampling import _fill, _x
from test_torch_train import _jax_model

K = jax.random.PRNGKey
CFG = entry.FLOW_MOTION_TINY
SS = CFG["second_stage"]
S, M, B, T = SS["spatial"], SS["min_spatial"], SS["batch_size"], SS["T"]
Z_FLOW = CFG["architecture"]["flow_vae_channels"]
Z_TOTAL = SS["z_dim"]
# the keys of the JAX functions' draws
DENSITY_KEY, SAMPLE_KEY, VIDEO_KEY = K(11), K(9), K(10)


def _vae_args(cfg):
    arch = cfg["architecture"]
    return (cfg["second_stage"]["spatial"], arch["flow_vae_channels"],
            arch["flow_vae_nf_max"], cfg["second_stage"]["min_spatial"])


def _flow_input_draws(rng):
    """The draws of the JAX ``FlowMotionModel.make_flow_input(rng)``: the
    VAE's eps from the first split key, the extra channels from the second
    (computed inside the jitted reference, then handed to the port)."""
    r1, r2 = jax.random.split(rng)
    return (jax.random.normal(r1, (B, M, M, Z_FLOW), jnp.float32),
            jax.random.normal(r2, (B, M, M, Z_TOTAL - Z_FLOW), jnp.float32))


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    """The JAX bridge model and the port's, carrying the same numpy weights
    over the JAX shapes (non-trivial out convs, random spectral-norm u),
    the JAX frozen bundles and params, and a synthetic batch."""
    ss_model, ss_shapes = _jax_model(SS, False)
    fv = jts.ConvFlowVAE(*_vae_args(CFG))
    jmodel = jts.FlowMotionModel(Config(CFG), ss_model, fv)
    shapes = dict(ss_shapes, fv=jax.eval_shape(lambda: fv.init(
        {"params": K(5)}, jnp.zeros((1, S, S, 2)), rng=K(6))),
        inn=jax.eval_shape(lambda: jmodel.init(K(7))["inn"]))
    values = _fill(shapes, np.random.default_rng(21))
    frozen = {k: FrozenBundle(_jnp(values[k]["params"]),
                              _jnp(values[k].get("batch_stats", {})))
              for k in ("fs", "cond", "poke")}
    frozen["flow_vae"] = FrozenBundle(_jnp(values["fv"]["params"]),
                                      _jnp(values["fv"]["batch_stats"]))

    port_ss = entry.make_model(SS, flow_params(values["flow"]))
    for sub, name in ((port_ss.first_stage, "fs"), (port_ss.conditioner, "cond"),
                      (port_ss.poke_embedder, "poke")):
        load_flax(sub, values[name]["params"], values[name].get("batch_stats"))
    port = tts.FlowMotionModel(CFG, port_ss, _port_vae(values),
                               flow_params(values["inn"]))
    batch = {k: v for k, v in jax_make_batch(
        np.random.default_rng(0), batch_size=B, n_frames=T, spatial_size=S).items()
        if k in ("images", "poke", "flow")}
    return jmodel, frozen, values, port.eval(), batch


def _port_vae(values):
    vae = tts.ConvFlowVAE(*_vae_args(CFG))
    load_flax(vae, values["fv"]["params"], values["fv"]["batch_stats"])
    return vae


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """The JAX side, one jitted program: the bridge's ``forward_density``
    (with a key), ``forward_sample_flow`` and ``forward_video_from_flow``,
    and those functions' draws."""
    jmodel, frozen, values, _, batch = tiny

    @jax.jit
    def run(frozen, batch, inn, ss):
        return {"density": jmodel.forward_density(inn, frozen, batch, DENSITY_KEY),
                "density_noise": _flow_input_draws(DENSITY_KEY),
                "z": jax.random.normal(SAMPLE_KEY, (B, M, M, Z_TOTAL)),
                "video_noise": _flow_input_draws(VIDEO_KEY),
                "flow": jmodel.forward_sample_flow(inn, frozen, batch, SAMPLE_KEY),
                "video": jmodel.forward_video_from_flow(inn, ss, frozen, batch,
                                                        VIDEO_KEY, T)}

    out = run(frozen, _jnp(batch), {"inn": _jnp(values["inn"])},
              {"flow": _jnp(values["flow"])})
    return jax.tree_util.tree_map(np.asarray, out)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_bridge_forward_inverse_match_jax(tiny, jax_ref):
    """The unconditioned bridge (h_channels 0): ``forward_density`` with
    JAX's draws against JAX's (output and logdet), and the inverse of JAX's
    output back to the flow input.  The unit inverses take the K2 route
    (its plain version on the CPU) with no conditioning rows."""
    _, _, _, port, batch = tiny
    ref = jax_ref
    out, logdet = ref["density"]
    noise = tuple(map(_t, ref["density_noise"]))
    with torch.no_grad():
        got, got_ld = port.forward_density(_tbatch(batch), noise=noise)
        x = port.make_flow_input(_tbatch(batch), noise=noise)
        back = port.inn.inverse(port.inn_params.tree(), _t(out), None)
    np.testing.assert_allclose(got.numpy(), out, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_ld.numpy(), logdet, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=2e-4, rtol=2e-4)


def test_bridge_units_take_k2_without_conditioning(tiny, monkeypatch):
    """Every unit of the bridge's inverse goes to K2's wrapper (its plain
    version on the CPU) with no conditioning tensor, and K2 takes every
    unit of ``FLOW_MOTION``'s bridge (B = 32, 8x8, C = 32 and 28, hid = 4C)
    by ``unit_fits``."""
    from ipoke_tpu_torch.ops import masked_conv

    _, _, _, port, _ = tiny
    calls, unit = [], masked_conv.macow_unit_inverse

    def record(y, h, *args, **kw):
        calls.append(h)
        return unit(y, h, *args, **kw)

    monkeypatch.setattr(masked_conv, "macow_unit_inverse", record)
    with torch.no_grad():
        port.inn.inverse(port.inn_params.tree(), _t(_x((B, M, M, Z_TOTAL), 36)), None)
    assert calls == [None] * (4 * sum(CFG["architecture"]["num_steps"]))
    cfg = entry.FLOW_MOTION
    with torch.device("meta"):  # the modules alone: no parameter tree
        bridge = tts.FlowMotionModel(cfg, entry.make_model(cfg["second_stage"]),
                                     tts.ConvFlowVAE(64, 8, 64, 8)).inn
    shapes = [(32, 8, 8, prior.in_channels) for _, prior, _, _ in bridge._levels()]
    assert [c for *_, c in shapes] == [32, 28]
    assert all(masked_conv.unit_fits(sh, 4 * sh[-1], (2, 3)) for sh in shapes)


@pytest.mark.parametrize("path", ["hallucinated_flow", "video_from_flow"])
def test_sampling_paths_match_jax(tiny, jax_ref, path):
    """``forward_sample_flow`` (z ~ N(0, I) -> bridge inverse -> VAE decode)
    and ``forward_video_from_flow`` (flow -> VAE sample -> bridge forward ->
    second-stage inverse -> decode), with JAX's draws of the same key."""
    _, _, _, port, batch = tiny
    ref = jax_ref
    if path == "hallucinated_flow":
        got = port.forward_sample_flow(_tbatch(batch), z=_t(ref["z"]))
        assert got.shape == (B, S, S, 2)
    else:
        got = port.forward_video_from_flow(_tbatch(batch), T,
                                           noise=tuple(map(_t, ref["video_noise"])))
        assert got.shape == (B, T, S, S, 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref["flow" if path == "hallucinated_flow"
                                                 else "video"], atol=2e-3)


@pytest.mark.parametrize("epoch,factor", [(0, 1), (8, 1), (9, 2), (19, 4)])
def test_double_recon_weight_schedule_matches_jax(epoch, factor):
    """x2 from epoch 9, x4 from 19, whatever the state's current weight."""
    jstate = jts.ThirdStageState(params={}, opt=(), step=jnp.zeros((), jnp.int32),
                                 weight_recon=jnp.asarray(7.0))
    want = jts.double_recon_weight_schedule(jstate, epoch, 0.5)
    got = tts.double_recon_weight_schedule(tts.ThirdStageState(None, 3, 7.0),
                                           epoch, 0.5)
    assert got.weight_recon == float(want.weight_recon) == 0.5 * factor
    assert got.step == 3


def test_flow_errors_match_jax():
    f1, f2 = _x((2, 5, 6, 2), 34, 3.0), _x((2, 5, 6, 2), 35, 3.0)
    f2[0, 0, 0] = f1[0, 0, 0]  # a zero angle, where arccos meets its clip
    for jfn, tfn in ((jmetrics.angular_error, angular_error),
                     (jmetrics.endpoint_error, endpoint_error)):
        np.testing.assert_allclose(tfn(_t(f1), _t(f2)).numpy(),
                                   _np(jfn(jnp.asarray(f1), jnp.asarray(f2))),
                                   atol=1e-5)
