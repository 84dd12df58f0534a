"""The port's FC baseline tower (``models/fc_baseline.py``) against the JAX
package's, fp32 on the CPU, with the same weights carried by
``convert.load_flax``:

* flax's ``nn.GRUCell`` (biases on ir, iz, in and hn only) within 1e-6;
* ``FirstStageFCWrapper`` (deterministic, variational, ``poke_and_image``)
  encode and decode, eval and train (every spectral norm's new u), within
  1e-4;
* ``FCBaselineModel`` at ``entry.FC_TINY`` (32 px): the train forward
  (frame by frame, every u after T updates) and the eval forward (one
  batched decode, the SPADE modulations once per clip) within 1e-4;
* two first-stage steps with the FC model (discriminator gate 1, then 0)
  against the jitted ``make_first_stage_train_step`` (this file's one
  compiled program) by ``tests/test_torch_first_stage.py``'s rule, on its
  noisy batch; in the second step JAX's gradient of the motion encoder's
  first layers parts from float64 (the port's fp32 does not), so there
  float64 is the reference;
* ``first_stage_fc.yaml``'s 64 px with four ``dec_channels``, which render
  32 px: the JAX step fails to trace, the port's build raises.

The JAX forwards are outputs of the step's jitted program (``jax_run``):
one trace and compile in place of ~430 eagerly compiled primitives."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models import fc_baseline as jfcb
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.nn import vgg as jvgg
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.core.config import load_config
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import fc_baseline as tfcb
from ipoke_tpu_torch.models import first_stage as tfs
from ipoke_tpu_torch.nn import vgg as tv

from test_torch_first_stage import (_assert_moments, _assert_stats, _jax_state, _like,
                                    _moments, _per_net)
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill, _x

K = jax.random.PRNGKey
CFG = entry.FC_TINY["first_stage"]
S, T, B = CFG["data"]["spatial_size"][0], CFG["data"]["max_frames"], 2
LR = CFG["training"]["lr"]


def _close(got, want, tol=1e-4, what=""):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def test_gru_cell_matches_flax():
    cell = fnn.GRUCell(features=8)
    h, x = _x((B, 8), 1), _x((B, 6), 2)
    values = _fill(jax.eval_shape(lambda: cell.init(K(0), jnp.asarray(h), jnp.asarray(x))),
                   np.random.default_rng(3))
    want, _ = cell.apply(_jnp(values), jnp.asarray(h), jnp.asarray(x))
    port = tfcb.GRUCell(6, 8)
    load_flax(port, values["params"])
    assert sorted(n for n, _ in port.named_parameters()) == sorted(
        f"{g}.{p}" for g in ("ir", "iz", "in", "hr", "hz", "hn")
        for p in (("kernel", "bias") if g in ("ir", "iz", "in", "hn") else ("kernel",)))
    _close(port(_t(h), _t(x)), want, 1e-6)


WRAPPERS = ("deterministic", "variational", "poke_and_image")


def _wrapper_case(variant):
    """(flax wrapper, input, numpy values, port kwargs) of one variant."""
    nf_in = 2 if variant == "poke_and_image" else 3
    kw = dict(deterministic=variant != "variational",
              poke_and_image=variant == "poke_and_image")
    jmodel = jfcb.FirstStageFCWrapper(spatial_size=S, nf_in=nf_in, nf_max=16, **kw)
    x = _x((B, S, S, nf_in + (3 if kw["poke_and_image"] else 0)), 4)
    values = _fill(jax.eval_shape(lambda: jmodel.init(
        {"params": K(0)}, jnp.asarray(x), train=False)), np.random.default_rng(5))
    return jmodel, x, values, dict(kw, nf_in=nf_in)


def _wrapper_outputs(jmodel, x, v):
    z, mean, logstd = jmodel.apply(v, x, rng=K(6), method=jmodel.encode)
    rec = jmodel.apply(v, mean, method=jmodel.decode)
    rec_t, new = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
    return {"z": z, "mean": mean, "logstd": logstd, "rec": rec, "rec_t": rec_t,
            "stats": new["batch_stats"]}


@pytest.mark.parametrize("variant", WRAPPERS)
def test_fc_wrapper_matches_flax(jax_run, variant):
    """encode (with the JAX draw where variational), decode, and the train
    forward with every spectral norm's new u."""
    _, x, values, kw = jax_run["wrappers"][variant]
    kw = dict(kw)
    want = jax_run["first"][2]["wrappers"][variant]
    nf_in = kw.pop("nf_in")
    port = tfcb.FirstStageFCWrapper(S, nf_in, 16, **kw)
    load_flax(port, values["params"], values["batch_stats"])
    mean = want["mean"]
    noise = jax.random.normal(K(6), mean.shape) if variant == "variational" else None
    got_z, got_mean, got_logstd = port.encode(_t(x), noise=None if noise is None else _t(noise))
    _close(got_z, want["z"], what="z")
    _close(got_mean, mean, what="mean")
    assert (got_logstd is None) == (want["logstd"] is None)
    if want["logstd"] is not None:
        _close(got_logstd, want["logstd"], what="logstd")
    _close(port.decode(got_mean), want["rec"], what="decode")
    _close(port(_t(x), train=True), want["rec_t"], what="train forward")
    assert _assert_stats(port, want["stats"], rtol=1e-4, atol=1e-5) > 0


@pytest.fixture(scope="module")
def tiny():
    """numpy weights over the JAX shapes of the FC first stage, both
    discriminators and VGG, and ``tests/test_torch_first_stage.py``'s
    noisy synthetic batch (its ``tiny`` docstring says why the noise)."""
    model, disc_s, disc_t = jfs.build_first_stage(Config(CFG))
    mf_dt = tfs._dt_frames(CFG)
    shapes = jax.eval_shape(lambda: {
        "g": model.init({"params": K(0)}, jnp.zeros((1, T + 1, S, S, 3)),
                        rng=K(1), train=False),
        "dt": disc_t.init({"params": K(2)}, jnp.zeros((1, mf_dt, S, S, 3))),
        "ds": disc_s.init({"params": K(3)}, jnp.zeros((1, S, S, 3))),
        "vgg": jvgg.VGG19Features().init(K(4), jnp.zeros((1, 64, 64, 3)))})
    values = _fill(shapes, np.random.default_rng(11))
    batch = jax_make_batch(np.random.default_rng(0), batch_size=B, n_frames=T,
                           spatial_size=S)["images"]
    return (model, disc_s, disc_t), values, batch + _x(batch.shape, 14, 1e-2)


def _port_nets(values):
    with torch.device("meta"):
        nets = (*tfs.build_first_stage(CFG), tv.VGG19Features())
    nets = tuple(n.to_empty(device="cpu") for n in nets)
    for net, key in zip(nets, ("g", "ds", "dt", "vgg")):
        load_flax(net, values[key]["params"], values[key].get("batch_stats"))
    return nets


@pytest.fixture(scope="module")
def jax_run(tiny):
    """This file's one JAX program, jitted: the first-stage step with the FC
    model, which also returns, from the initial weights it is given, the FC
    model's eval and train forwards (the clip's encoding with the JAX draw,
    the GRU rollout and the decode) and every wrapper variant's encode,
    decode and train forward.  ``first`` holds its call on the initial
    state at gate 1 with ``K(20)``."""
    (model, disc_s, disc_t), values, batch = tiny
    tx = joptim.gan_adam(LR)
    jstep = jfs.make_first_stage_train_step(
        Config(CFG), model, disc_s, disc_t, _jnp(values["vgg"]), tx, tx, tx)
    wrappers = {v: _wrapper_case(v) for v in WRAPPERS}

    @jax.jit
    def run(state, batch, key, gate, g, wv):
        state, metrics = jstep(state, batch, key, gate)
        out = {}
        for train in (False, True):
            if train:
                (X_hat, mu, logvar), new = model.apply(g, batch["images"], rng=K(12),
                                                       train=True, mutable=["batch_stats"])
                out["stats"] = new["batch_stats"]
            else:
                X_hat, mu, logvar = model.apply(g, batch["images"], rng=K(12), train=False)
            out["train" if train else "eval"] = (X_hat, mu, logvar)
        out["wrappers"] = {v: _wrapper_outputs(wrappers[v][0], wrappers[v][1], wv[v])
                           for v in WRAPPERS}
        return state, metrics, out

    g = _jnp(values["g"])
    wv = {v: _jnp(wrappers[v][2]) for v in WRAPPERS}
    call = lambda state, key, gate: run(state, {"images": jnp.asarray(batch)}, key,
                                        gate, g, wv)
    state0 = _jax_state(values, tx)
    return {"call": call, "state0": state0, "first": call(state0, K(20), 1.0),
            "wrappers": wrappers}


@pytest.mark.parametrize("train", [False, True])
def test_fc_baseline_forward_matches_flax(tiny, jax_run, train):
    """The clip's encoding with the JAX draw, the GRU rollout and the
    decode: frame by frame in train mode (each u advanced T times), one
    batched call in eval."""
    _, values, batch = tiny
    X_hat, mu, logvar = jax_run["first"][2]["train" if train else "eval"]
    port = _port_nets(values)[0]
    noise = jax.random.normal(K(12), mu.shape)
    assert isinstance(port, tfcb.FCBaselineModel) and mu.shape == (B, 8)
    got, got_mu, got_logvar = port(_t(batch), train=train, noise=_t(noise))
    for a, b, what in ((got_mu, mu, "mu"), (got_logvar, logvar, "logvar"),
                       (got, X_hat, "frames")):
        _close(a, b, what=what)
    assert got.shape == (B, T, S, S, 3)
    if train:
        assert _assert_stats(port, jax_run["first"][2]["stats"], rtol=1e-4, atol=1e-5) > 0


def _draws(rng):
    """The JAX step's draws from its ``rng``, as ``sample_draws`` returns
    them (the FC encoder's noise is a (B, z_dim) vector)."""
    r_enc, r_off, r_true, r_fake, _ = jax.random.split(rng, 5)
    n_ex = CFG["d_s"]["n_examples"]
    hi = max(1, T + 1 - tfs._dt_frames(CFG))
    return {"noise": _t(jax.random.normal(r_enc, (B, CFG["architecture"]["z_dim"]))),
            "offset": int(jax.random.randint(r_off, (), 0, hi)),
            "idx_t": torch.tensor(np.asarray(jax.random.randint(
                r_true, (n_ex,), 0, B * (T + 1))), dtype=torch.long),
            "idx_f": torch.tensor(np.asarray(jax.random.randint(
                r_fake, (n_ex,), 0, B * T)), dtype=torch.long)}


def _float64_moments(nets, txs, batch, draws, gate):
    """The first moments of the three nets after the same step in float64,
    from the same state."""
    nets = [copy.deepcopy(n).double() for n in nets]
    txs64 = tfs.create_first_stage_state(*nets[:3], lambda ps: gan_adam(ps, LR))
    for t64, t in zip(txs64, txs):
        t64.count = t.count
        for q64, q in zip(t64.params, t.params):
            t64.adam.state[q64] = {k: v.double().clone() for k, v in t.adam.state[q].items()}
    draws = dict(draws, noise=draws["noise"].double())
    tfs.FirstStageStep(CFG, *nets, *txs64)({"images": _t(batch).double()}, draws, gate)
    return [[t.adam.state[q]["exp_avg"] for q in t.params] for t in txs64]


def test_fc_first_stage_steps_match_jax(tiny, jax_run):
    """Two steps of the jitted JAX step and of the port's ``FirstStageStep``
    on the FC model at gate 1 then 0, each from the same state (after step
    1 JAX's params, u and Adam moments are loaded into the port): every
    metric within 1e-4 relative, every u within 1e-4, params within 2 lr
    with at most 1% past lr / 10, first moments by leaf norm; the gate-0
    step leaves the discriminators as they were.

    In step 2 JAX's first moments of the motion encoder's stem and first
    block part from a float64 step from the same state past the rule,
    where the port's fp32 holds it: there the port's first moments are
    held to float64 by the rule, and to JAX by leaf norm within 1e-2 of
    the moment (the step's mean of old moment and new gradient)."""
    _, values, batch = tiny
    nets = _port_nets(values)
    txs = tfs.create_first_stage_state(*nets[:3], lambda ps: gan_adam(ps, LR))
    step = tfs.FirstStageStep(CFG, *nets, *txs)
    state = jax_run["state0"]
    for gate, key in ((1.0, K(20)), (0.0, K(21))):
        before = [[t.detach().clone() for t in net.parameters()] for net in nets[:3]]
        moments = [_moments(t) for t in txs]
        state, want, _ = jax_run["first"] if gate == 1.0 else \
            jax_run["call"](state, key, gate)
        f64 = _float64_moments(nets, txs, batch, _draws(key), gate) if gate == 0.0 else None
        got = step({"images": _t(batch)}, _draws(key), gate)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"gate {gate}: {k}")
        for i, (net, t, p0, (params, stats, adam)) in enumerate(
                zip(nets[:3], txs, before, _per_net(state))):
            _assert_stats(net, stats, rtol=1e-4, atol=1e-4)
            names = [n for n, _ in net.named_parameters()]
            off = 0
            for name, g, w in zip(names, net.parameters(), _like(net, params, stats)):
                torch.testing.assert_close(g.detach(), w, rtol=0, atol=2 * LR, msg=name)
                off += int(((g.detach() - w).abs() > 0.1 * LR).sum())
            assert off <= 0.01 * sum(p.numel() for p in p0), (i, off)
            if gate == 0.0 and i > 0:
                assert all(torch.equal(a, b) for a, b in zip(p0, net.parameters()))
                for a, b in zip(moments[i], _moments(t)):
                    assert all(torch.equal(a[k], b[k]) for k in a)
                continue
            assert all(not torch.equal(a, b) for a, b in zip(p0, net.parameters()))
            mu = [t.adam.state[q]["exp_avg"] for q in t.params]
            want_mu = _like(net, adam.mu, stats)
            if f64 is None:
                _assert_moments(mu, want_mu, names)
                continue
            _assert_moments(mu, [m.float() for m in f64[i]], names)
            for name, a, b in zip(names, mu, want_mu):
                assert (a - b).norm() <= 1e-2 * b.norm() + 1e-6, name
        for net, (params, stats, adam), t in zip(nets[:3], _per_net(state), txs):
            load_flax(net, params, stats)
            for key_t, key_j in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                for q, w in zip(t.params, _like(net, getattr(adam, key_j), stats)):
                    t.adam.state[q][key_t].copy_(w)


def test_yaml_size_mismatch_fails_in_both():
    """``config/first_stage_fc.yaml`` asks for 64 px, but its four
    dec_channels render 32 px: the JAX step fails when it traces (the
    32 px frames do not join the 64 px clip), and the port refuses the
    config at build, naming both sizes.  Small widths, the yaml's sizes."""
    cfg = copy.deepcopy(load_config("config/first_stage_fc.yaml").to_dict())
    cfg["architecture"].update(ENC_M_channels=[8, 8, 8, 8], dec_channels=[8, 8, 8, 8])
    cfg["d_s"].update(ndf=8, n_layers=2)
    cfg["d_t"]["max_frames"] = 3
    cfg["data"]["max_frames"] = 2
    s = cfg["data"]["spatial_size"][0]
    assert s == 64
    model, disc_s, disc_t = jfs.build_first_stage(Config(cfg))
    tx = joptim.gan_adam(1e-3)
    jstep = jfs.make_first_stage_train_step(Config(cfg), model, disc_s, disc_t,
                                            jvgg.init_vgg_params(0), tx, tx, tx)
    X = jnp.zeros((1, 3, s, s, 3))
    shapes = jax.eval_shape(lambda: {
        "g": model.init({"params": K(0)}, X, rng=K(1), train=False),
        "dt": disc_t.init({"params": K(2)}, X),
        "ds": disc_s.init({"params": K(3)}, X[:, 0])})
    frames = jax.eval_shape(lambda v: model.apply(v, X, rng=K(1)), shapes["g"])[0]
    assert frames.shape == (1, 2, 32, 32, 3)  # rendered at 32 px
    state = jax.eval_shape(lambda sh: _jax_state(sh, tx), shapes)
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(jstep, state, {"images": X}, K(5), 1.0)
    with pytest.raises(ValueError, match="renders 32 px .*spatial_size is 64"):
        tfs.build_first_stage(cfg)
