"""The port's PokeVAE baseline and RNNMotionModel
(``ipoke_tpu_torch/models/poke_vae.py``) against the JAX package's
(``ipoke_tpu/models/poke_vae.py``) on CPU in fp32, at the first stage's
TINY config with ``architecture.baseline``: two whole VAE-GAN steps for
each ``stack_motion_and_poke`` option against the jitted
``make_first_stage_train_step`` (the same weights carried by
``convert.load_flax``, batch and draws), RNNMotionModel's eval forward, and
the shapes of the eval decode and ``sample_prior``.  All JAX references
come from one jitted program."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.models import poke_vae as jpv
from ipoke_tpu.nn import vgg as jvgg
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import first_stage as tfs
from ipoke_tpu_torch.models import poke_vae as tpv
from ipoke_tpu_torch.nn import vgg as tv

from test_torch_first_stage import (
    _assert_stats,
    _jax_draws,
    _jax_state,
    _like,
    _per_net,
)
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill, _x

K = jax.random.PRNGKey
TINY = entry.FIRST_STAGE_TINY
S, T, B = TINY["data"]["spatial_size"][0], TINY["data"]["max_frames"], 2
LR = TINY["training"]["lr"]
GATES = (1.0, 0.0)
STACK = (False, True)


def _config(stack):
    cfg = copy.deepcopy(TINY)
    cfg["architecture"].update(baseline=True, stack_motion_and_poke=stack)
    return cfg


def _rnn_kwargs():
    a = TINY["architecture"]
    return dict(spatial_size=S, z_dim=a["z_dim"], enc_channels=tuple(a["ENC_M_channels"]),
                dec_channels=tuple(a["dec_channels"]), n_gru_layers=a["n_gru_layers"],
                min_spatial_size=a["min_spatial_size"], max_frames=T)


@pytest.fixture(scope="module")
def run():
    """numpy weights over the JAX shapes (both PokeVAEs, the
    discriminators, VGG, an RNNMotionModel), a synthetic batch with its
    poke (N(0, 0.01^2) added to the frames: ``test_torch_first_stage``'s
    ``tiny`` says why), and one jitted program's outputs: per stacking
    option the JAX step's state and metrics after each of two steps
    (disc_gate 1, then 0; ``lax.scan`` traces the step once), and the
    RNNMotionModel's eval forward."""
    rng = np.random.default_rng(31)
    models = {st: jfs.build_first_stage(Config(_config(st))) for st in STACK}
    _, disc_s, disc_t = models[False]
    rnn_model = jpv.RNNMotionModel(**_rnn_kwargs())
    X0, P0 = jnp.zeros((1, T + 1, S, S, 3)), jnp.zeros((1, S, S, 2))
    mf_dt = tfs._dt_frames(TINY)
    shapes = jax.eval_shape(lambda: {
        **{f"g{int(st)}": models[st][0].init({"params": K(0)}, X0, rng=K(1), poke=P0)
           for st in STACK},
        "dt": disc_t.init({"params": K(2)}, jnp.zeros((1, mf_dt, S, S, 3))),
        "ds": disc_s.init({"params": K(3)}, jnp.zeros((1, S, S, 3))),
        "vgg": jvgg.VGG19Features().init(K(4), jnp.zeros((1, 64, 64, 3))),
        "rnn": rnn_model.init({"params": K(5)}, X0, rng=K(6))})
    values = _fill(shapes, rng)
    raw = jax_make_batch(np.random.default_rng(0), batch_size=B, n_frames=T,
                         spatial_size=S)
    batch = {"images": raw["images"] + _x(raw["images"].shape, 14, 1e-2),
             "poke": raw["poke"]}
    tx = joptim.gan_adam(LR)
    steps = {st: jfs.make_first_stage_train_step(
        Config(_config(st)), *models[st], _jnp(values["vgg"]), tx, tx, tx) for st in STACK}
    keys = jnp.stack([K(40), K(41)])

    @jax.jit
    def program(states, jbatch, rnn_vars):
        out = {}
        for st in STACK:
            def body(state, kg, st=st):
                state, metrics = steps[st](state, jbatch, kg[0], kg[1])
                return state, (state, metrics)
            out[st] = jax.lax.scan(body, states[st], (keys, jnp.asarray(GATES)))[1]
        rnn = rnn_model.apply(rnn_vars, jbatch["images"], rng=K(7), train=False)
        return out, rnn

    states = {st: _jax_state({"g": values[f"g{int(st)}"], "ds": values["ds"],
                              "dt": values["dt"]}, tx) for st in STACK}
    out, rnn = program(states, _jnp(batch), _jnp(values["rnn"]))
    return values, batch, keys, out, rnn


def _port_nets(values, stack):
    cfg = _config(stack)
    with torch.device("meta"):
        nets = (*tfs.build_first_stage(cfg), tv.VGG19Features())
    nets = tuple(n.to_empty(device="cpu") for n in nets)
    for net, key in zip(nets, (f"g{int(stack)}", "ds", "dt", "vgg")):
        load_flax(net, values[key]["params"], values[key].get("batch_stats"))
    return nets


def _assert_moments(got, want, names, rel):
    """``test_torch_first_stage._assert_moments`` with the leaf-norm share
    ``rel`` in place of its 3e-4."""
    got, want = [np.asarray(g) for g in got], [np.asarray(w) for w in want]
    assert len(got) == len(want) > 0
    floor = 1e-4 * np.sqrt(np.mean(np.concatenate([w.ravel() for w in want]) ** 2))
    for name, g, w in zip(names, got, want):
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w) + floor * w.size ** 0.5, name


# Adam's first moments, leaf norm share: 3e-4 as in test_torch_first_stage;
# stacked, the motion encoder's first moments of the JAX step in fp32 part
# from its own float64 step by 2.5e-3-5e-3 of their norm, every leaf alike,
# where the port's fp32 parts from the port's float64 by 5e-6 and the two
# packages' float64 steps agree within 6e-6 (measured on this CPU): the
# bound holds JAX's fp32 rounding, and a wrong backward parts them by O(1)
MOMENT_REL = {False: 3e-4, True: 1e-2}


@pytest.mark.parametrize("stack", STACK)
def test_poke_vae_steps_match_jax(run, stack):
    """Two steps at disc_gate 1 then 0 from the same weights, batch (its
    poke in both generator forwards) and draws (the JAX step's keys), at
    TINY's constant lr, by ``test_torch_first_stage``'s rules: every metric
    within 1e-4 abs + rel (the adversarial terms read the discriminators
    after their Adam step, where a near-zero gradient entry takes its sign
    from rounding and moves a full lr either way: loss_g_t, the mean of O(1)
    logits near 0, reads 4e-5 apart at step 1 without stacking), every
    spectral norm's u and sigma within 1e-4,
    params within 2 lr with at most 1% past lr / 10, Adam's first moments
    by leaf norm (``MOMENT_REL``); before step 2 JAX's state is loaded into
    the port."""
    values, batch, keys, out, _ = run
    cfg = _config(stack)
    nets = _port_nets(values, stack)
    assert isinstance(nets[0], tpv.PokeVAEModel) and nets[0].needs_poke
    txs = tfs.create_first_stage_state(*nets[:3], lambda ps: gan_adam(ps, LR))
    step = tfs.FirstStageStep(cfg, *nets, *txs)
    states, metrics = out[stack]
    tbatch = {k: _t(v) for k, v in batch.items()}
    for i, gate in enumerate(GATES):
        state = jax.tree_util.tree_map(lambda a: a[i], states)
        got = step(tbatch, _jax_draws(keys[i], cfg), gate)
        assert got.keys() == metrics.keys()
        for k in metrics:
            np.testing.assert_allclose(got[k].item(), float(metrics[k][i]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i}: {k}")
        for j, (net, t, (params, stats, adam)) in enumerate(zip(nets[:3], txs,
                                                                _per_net(state))):
            _assert_stats(net, stats, rtol=1e-4, atol=1e-4)
            names = [n for n, _ in net.named_parameters()]
            off, n = 0, 0
            for name, g, w in zip(names, net.parameters(), _like(net, params, stats)):
                g = g.detach()
                torch.testing.assert_close(g, w, rtol=0, atol=2 * LR, msg=name)
                off, n = off + int(((g - w).abs() > 0.1 * LR).sum()), n + g.numel()
            assert off <= 0.01 * n, (i, j, off)
            if gate == 0.0 and j > 0:
                continue
            _assert_moments([t.adam.state[q]["exp_avg"] for q in t.params],
                            _like(net, adam.mu, stats), names, MOMENT_REL[stack])
        for net, (params, stats, adam), t in zip(nets[:3], _per_net(state), txs):
            load_flax(net, params, stats)  # the same state for the next step
            for key_t, key_j in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                for q, w in zip(t.params, _like(net, getattr(adam, key_j), stats)):
                    t.adam.state[q][key_t].copy_(w)
    # the batched eval decode and a prior draw, both under the poke
    model = nets[0]
    with torch.no_grad():
        X, poke = tbatch["images"], tbatch["poke"]
        noise = torch.randn((B, *tfs.latent_shape(cfg)), generator=torch.Generator()
                            .manual_seed(0))
        for kw in ({"noise": noise}, {"noise": noise, "sample_prior": True}):
            X_hat, mu, logvar = model(X, poke=poke, **kw)
            assert X_hat.shape == (B, T, S, S, 3) and bool(torch.isfinite(X_hat).all())
            assert mu.shape == logvar.shape == noise.shape
        assert torch.equal(mu, torch.zeros_like(mu))  # the prior's
        with pytest.raises(ValueError, match="poke map"):
            model(X, noise=noise)


def test_rnn_motion_model_matches_jax(run):
    """RNNMotionModel's eval forward (the encoder's draw from the same key,
    scene encoder, GRU rollout through ``post_hidden``, the batched
    ConvDecoder) within 1e-4."""
    values, batch, _, _, (X_hat, mu, logvar) = run
    model = tpv.RNNMotionModel(**_rnn_kwargs()).to_empty(device="cpu")
    load_flax(model, values["rnn"]["params"], values["rnn"].get("batch_stats"))
    noise = _t(jax.random.normal(K(7), mu.shape))
    with torch.no_grad():
        got = model(_t(batch["images"]), noise=noise)
    for a, b in zip(got, (X_hat, mu, logvar)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-4, atol=1e-4)
