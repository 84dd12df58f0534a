"""The port's first stage under ``training.mixed_prec`` (bf16 compute over
fp32 params, as the JAX package's ``dtype=bfloat16`` nets) against the
jitted JAX step at the TINY config, and ``full_sequence: false`` (the motion
encoder's stride plan and the clip without its start frame) against the
JAX model in fp32, computed in the step's jitted program (``jax_run``).
Weights, batch and draws as in ``tests/test_torch_first_stage.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.nn.motion import ResNetMotionEncoder as JMotion
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import first_stage as tfs
from ipoke_tpu_torch.nn import vgg as tv
from ipoke_tpu_torch.nn.motion import ResNetMotionEncoder

from test_torch_first_stage import (B, LR, T, TINY, _jax_state, _like, _moments,
                                    _per_net, tiny)  # noqa: F401 (fixture)
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill, _x

K = jax.random.PRNGKey


def _config(**training):
    cfg = copy.deepcopy(TINY)
    cfg["architecture"]["deterministic"] = True
    cfg["training"].update(training)
    return cfg


def _port_nets(values, cfg):
    with torch.device("meta"):
        nets = (*tfs.build_first_stage(cfg), tv.VGG19Features())
    nets = tuple(n.to_empty(device="cpu") for n in nets)
    for net, key in zip(nets, ("g", "ds", "dt", "vgg")):
        load_flax(net, values[key]["params"], values[key].get("batch_stats"))
    return nets


def _jax_draws(rng, cfg):
    """The JAX step's draws from ``rng``; the encoder's noise is drawn in
    the bf16 of its mu, as the JAX encoder draws it."""
    r_enc, r_off, r_true, r_fake, _ = jax.random.split(rng, 5)
    n_ex, s = cfg["d_s"]["n_examples"], cfg["architecture"]["min_spatial_size"]
    hi = max(1, T + 1 - tfs._dt_frames(cfg))
    noise = jax.random.normal(r_enc, (B, s, s, cfg["architecture"]["z_dim"]),
                              jnp.bfloat16)
    return {"noise": _t(noise),
            "offset": int(jax.random.randint(r_off, (), 0, hi)),
            "idx_t": torch.tensor(np.asarray(jax.random.randint(
                r_true, (n_ex,), 0, B * (T + 1))), dtype=torch.long),
            "idx_f": torch.tensor(np.asarray(jax.random.randint(
                r_fake, (n_ex,), 0, B * T)), dtype=torch.long)}


# measured on this CPU over the two steps (see the test's docstring)
METRIC_RTOL, ADV_RTOL = 5e-2, 0.5
ADV = ("loss_g_s", "loss_g_t", "loss_fmap_t", "loss")
GRAD_RATIO, GRAD_RATIO_MEDIAN = 8.0, 1.5


def _first_moments(txs):
    return [[t.adam.state[q]["exp_avg"].clone() for q in t.params] for t in txs]


def test_bf16_steps_match_jax(tiny, jax_run):
    """Two steps of the jitted JAX bf16 step (``build_first_stage`` with
    ``mixed_prec``: every conv, dense and the decoder's norms in bf16 over
    fp32 params, ``gan_adam`` on the fp32 params) and of the port, at
    disc_gate 1 then 0, step 2 from JAX's state.

    Both sides round every layer's output to bf16 (8 bits), but not at the
    same places inside a layer: XLA's CPU conv rounds as it does, oneDNN
    accumulates in fp32 and adds the bias before rounding; the hinge and L1
    kinks and d_t's max-pool ties then take other branches where a value
    sits within an ulp of them.  Measured on this CPU:

    * metrics: loss_g_s parts by 2.3e-2 relative at step 1, loss_g_t by
      1.4e-2, the rest by at most 5e-3; every metric within
      ``METRIC_RTOL`` (5e-2, ~6 bf16 ulps; in fp32 both sides agree to
      1e-4), but the generator's adversarial terms (``ADV``) within
      ``ADV_RTOL`` (0.5) of 1 + |JAX|: they read the discriminators after
      their own update, whose sign bf16 flips in ~20% of the entries, and
      on the card the CPU port's own bf16 loss_g_t moved from -0.254 to
      -0.457 between two machines (``chip_smoke.py``'s (q1));
    * gradients (Adam's first moments after step 1): bf16 parts JAX's from
      fp32 by 15-90% of a leaf's norm in the motion encoder and the GRU, so
      each leaf of the port's is held against JAX's by that departure:
      ||port - jax|| <= ``GRAD_RATIO`` x ||jax - fp32|| plus 1e-3 of
      the fp32 leaf, where fp32 is the port's fp32 step from the same
      weights (``tests/test_torch_first_stage.py`` holds it to JAX's within
      3e-4); the ratio's median over the leaves within
      ``GRAD_RATIO_MEDIAN`` (1.5).  Measured: median 0.98, largest 2.98 (a
      GRU bias where JAX's bf16 happens to lie near fp32); the card against
      the CPU port by the same rule read up to 3.43, hence the largest at
      ``GRAD_RATIO`` (8).  A fault in a layer's dtype or math would part
      the port's from both in most leaves;
    * params after step 1 within 2 lr of JAX's (Adam's first step is ~lr
      whatever the gradient's size);
    * the gate-0 step leaves the discriminators' params and moments as they
      were and moves the generator; outputs bf16, params fp32."""
    values, batch = tiny
    cfg = _config(mixed_prec=True)
    make = lambda ps: gan_adam(ps, LR)
    nets = _port_nets(values, cfg)
    txs = tfs.create_first_stage_state(*nets[:3], make)
    step = tfs.FirstStageStep(cfg, *nets, *txs)
    X_hat = nets[0](_t(batch), train=False)[0]
    assert X_hat.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for n in nets for p in n.parameters())
    # the port's fp32 step from the same weights and draws
    cfg32 = _config()
    nets32 = _port_nets(values, cfg32)
    txs32 = tfs.create_first_stage_state(*nets32[:3], make)
    tfs.FirstStageStep(cfg32, *nets32, *txs32)(
        {"images": _t(batch)}, _jax_draws(K(20), cfg), 1.0)
    fp32 = _first_moments(txs32)

    state = jax_run["state0"]
    for gate, key in ((1.0, K(20)), (0.0, K(21))):
        before = [[t.detach().clone() for t in net.parameters()] for net in nets[:3]]
        moments = [_moments(t) for t in txs]
        state, want, _ = jax_run["first"] if gate == 1.0 else \
            jax_run["call"](state, key, gate)
        got = step({"images": _t(batch)}, _jax_draws(key, cfg), gate)
        assert got.keys() == want.keys()
        for k in want:
            w = float(want[k])
            tol = ADV_RTOL * (1 + abs(w)) if k in ADV else METRIC_RTOL * abs(w) + 1e-3
            assert abs(got[k].float().item() - w) <= tol, (gate, k, got[k].item(), w)
        ratios = []
        for i, (net, t, p0, (params, stats, adam)) in enumerate(
                zip(nets[:3], txs, before, _per_net(state))):
            if gate == 0.0:
                moved = [not torch.equal(a, b) for a, b in zip(p0, net.parameters())]
                if i > 0:
                    assert not any(moved)
                    for a, b in zip(moments[i], _moments(t)):
                        assert all(torch.equal(a[k], b[k]) for k in a)
                else:
                    assert all(moved)
                continue
            names = [n for n, _ in net.named_parameters()]
            for name, g, w in zip(names, net.parameters(), _like(net, params, stats)):
                torch.testing.assert_close(g.detach(), w, rtol=1e-5, atol=2 * LR,
                                           msg=name)
            for name, g, w, f in zip(names, _first_moments(txs)[i],
                                     _like(net, adam.mu, stats), fp32[i]):
                ratio = float((g - w).norm() / ((w - f).norm() + 1e-3 * f.norm() + 1e-30))
                assert ratio <= GRAD_RATIO, (name, ratio)
                ratios.append(ratio)
        if ratios:
            assert np.median(ratios) <= GRAD_RATIO_MEDIAN, np.median(ratios)
        for net, (params, stats, adam), t in zip(nets[:3], _per_net(state), txs):
            load_flax(net, params, stats)  # the same state for the next step
            for key_t, key_j in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                for q, w in zip(t.params, _like(net, getattr(adam, key_j), stats)):
                    t.adam.state[q][key_t].copy_(w)


ENCODERS = ((3, (16, 16, 32, 32)), (16, (8, 8, 16, 16, 16)))


def _encoder_case(max_frames, channels):
    """(flax motion encoder with ``full_seq`` False, input, numpy values)."""
    kw = dict(channels=channels, z_dim=8, spatial_size=32, max_frames=max_frames,
              min_spatial_size=4, deterministic=True)
    x = np.random.default_rng(max_frames).standard_normal(
        (2, max_frames, 32, 32, 3)).astype(np.float32)
    jenc = JMotion(full_seq=False, **kw)
    shapes = jax.eval_shape(lambda: jenc.init(K(0), jnp.asarray(x)))
    return jenc, x, _fill(shapes, np.random.default_rng(1))


@pytest.fixture(scope="module")
def jax_run(tiny):
    """This file's one JAX program, jitted: the bf16 first-stage step, which
    also returns, from the weights it is given, the fp32 ``full_sequence:
    false`` model's ``encode`` and train-mode forward and both
    ``full_seq``-False motion encoders' outputs.  ``first`` holds its call
    on the initial state at gate 1 with ``K(20)``."""
    values, batch = tiny
    cfg = _config(mixed_prec=True)
    model, disc_s, disc_t = jfs.build_first_stage(Config(cfg))
    partial = jfs.build_first_stage(Config(_config(full_sequence=False)))[0]
    tx = joptim.gan_adam(LR)
    jstep = jfs.make_first_stage_train_step(
        Config(cfg), model, disc_s, disc_t, _jnp(values["vgg"]), tx, tx, tx)
    encoders = [_encoder_case(*case) for case in ENCODERS]

    @jax.jit
    def run(state, batch, key, gate, g, encoder_values):
        state, metrics = jstep(state, batch, key, gate)
        X = batch["images"]
        out = {"encode": partial.apply(g, X, method=partial.encode),
               "forward": partial.apply(g, X, train=True,
                                        mutable=["batch_stats"])[0][0],
               "encoders": [jenc.apply(v, x) for (jenc, x, _), v in
                            zip(encoders, encoder_values)]}
        return state, metrics, out

    g, ev = _jnp(values["g"]), [_jnp(v) for _, _, v in encoders]
    call = lambda state, key, gate: run(state, {"images": jnp.asarray(batch)}, key,
                                        gate, g, ev)
    state0 = _jax_state(values, tx)
    return {"call": call, "state0": state0, "first": call(state0, K(20), 1.0),
            "encoders": encoders}


@pytest.mark.parametrize("max_frames,channels", ENCODERS)
def test_motion_encoder_partial_sequence_matches_flax(jax_run, max_frames, channels):
    """``full_seq`` False: stage 1 keeps time where the channels suffice for
    log2(max_frames) and no time-only stage 4 runs at 16 frames; against
    flax, deterministic, fp32, within 1e-4."""
    case = ENCODERS.index((max_frames, channels))
    _, x, values = jax_run["encoders"][case]
    want = jax_run["first"][2]["encoders"][case]
    port = ResNetMotionEncoder(channels, 8, 32, max_frames, 4, True, False)
    load_flax(port, values["params"])
    got = port(_t(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), rtol=1e-4, atol=1e-4)


def test_partial_sequence_encode_and_forward_match_jax(tiny, jax_run):
    """``training.full_sequence: false``: the generator encodes the T frames
    after the start frame; ``encode`` and the train-mode forward against the
    JAX model's, fp32, within 1e-4."""
    values, batch = tiny
    cfg = _config(full_sequence=False)
    port = _port_nets(values, cfg)[0]
    assert not port.full_seq
    out = jax_run["first"][2]
    for a, b in zip(port.encode(_t(batch)), out["encode"]):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), rtol=1e-4, atol=1e-4)
    got = port(_t(batch), train=True)[0]
    np.testing.assert_allclose(got.detach().numpy(), _np(out["forward"]), rtol=1e-4,
                               atol=1e-4)


def test_mixed_first_stage_feeds_fp32_second_stage():
    """A first stage trained under ``mixed_prec`` computes in bf16 when the
    second stage loads it frozen (the JAX package builds it from its own
    config, ``dtype=bfloat16``); the fp32 flow takes its motion promoted to
    fp32, as flax promotes, and the density matches the fp32 first stage's
    within bf16 rounding of the motion."""
    from ipoke_tpu_torch import entry
    from ipoke_tpu_torch.nn.blocks import set_compute_dtype

    cfg = dict(entry.SMALL, spatial=32, min_spatial=4, T=3, z_dim=8,
               enc_ch=(16, 16, 32, 32), dec_ch=(32, 32, 16, 16), nf_cond=8,
               num_steps=(1, 1), mid_factor=2, batch_size=2, deterministic=True)
    model = entry.build(cfg, "cpu", torch.Generator().manual_seed(0))
    model.config["training"]["mixed_prec_master"] = False
    batch = entry.make_batch(cfg, "cpu")
    z32, ld32 = model.forward_density(batch)
    set_compute_dtype(model.first_stage, torch.bfloat16)
    assert model.encode_first_stage(batch["images"]).dtype == torch.bfloat16
    z, ld = model.forward_density(batch)
    assert z.dtype == ld.dtype == torch.float32
    torch.testing.assert_close(z, z32, atol=5e-2, rtol=5e-2)
