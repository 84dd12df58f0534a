"""The port's first-stage VAE-GAN train path (ipoke_tpu_torch) against the
JAX package's, on CPU in fp32 at the TINY config of
``tests/test_first_stage.py``: spectral norm against flax's
``SpectralNorm``, the generator's train-mode forward, and two whole train
steps against the jitted ``make_first_stage_train_step``, with the same
weights (carried by ``convert.load_flax``), inputs from numpy seeds and the
JAX step's own random draws.  The step's parts (discriminators, gradient
penalty, losses, VGG, ``gan_adam``, the trainer, the card rule against
float64) are ``tests/test_torch_first_stage_parts.py``'s."""

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
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.nn import vgg as jvgg
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax, spectral_norm_stats
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import first_stage as tfs
from ipoke_tpu_torch.nn import blocks as tb
from ipoke_tpu_torch.nn import discriminators as td
from ipoke_tpu_torch.nn import vgg as tv

from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill, _x

K = jax.random.PRNGKey
TINY = entry.FIRST_STAGE_TINY
S, T, B = TINY["data"]["spatial_size"][0], TINY["data"]["max_frames"], 2
LR = TINY["training"]["lr"]


def _config(deterministic):
    cfg = copy.deepcopy(TINY)
    cfg["architecture"]["deterministic"] = deterministic
    return cfg


def _holder(**modules):
    """A root module whose children carry the flax names of ``modules``."""
    root = torch.nn.Module()
    for name, m in modules.items():
        root.add_module(name, m)
    return root


def _sn_convs(module):
    return [(name, m) for name, m in module.named_modules()
            if getattr(m, "snorm", False)]


def _assert_stats(port, stats, rtol=1e-5, atol=1e-5):
    """Every spectral norm's u and sigma in ``port`` against the flax
    ``batch_stats`` tree ``stats``; returns how many."""
    convs = _sn_convs(port)
    assert convs
    for name, m in convs:
        u, sigma = spectral_norm_stats(stats, name.split("."))
        np.testing.assert_allclose(m.u.numpy(), _np(u), rtol=rtol, atol=atol,
                                   err_msg=f"{name}/u")
        np.testing.assert_allclose(m.sigma.numpy(), _np(sigma), rtol=rtol,
                                   atol=atol, err_msg=f"{name}/sigma")
    return len(convs)


def _assert_moments(got, want, names=None):
    """Adam's first moments leaf by leaf: within 3e-4 of the leaf's norm
    plus, per entry, 1e-4 of the RMS entry over all leaves (the biases that
    a one-channel-per-group norm cancels have a gradient of rounding noise
    on the scale of the net's gradients)."""
    got, want = [np.asarray(g) for g in got], [np.asarray(w) for w in want]
    assert len(got) == len(want) > 0
    floor = 1e-4 * np.sqrt(np.mean(np.concatenate([w.ravel() for w in want]) ** 2))
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.linalg.norm(g - w) <= 3e-4 * np.linalg.norm(w) + floor * w.size ** 0.5, \
            names[i] if names else i


def _assert_metrics(got, want, i):
    """Step ``i``'s metrics (tensors) against the JAX step's, stacked over
    steps: 1e-4 relative."""
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k][i], rtol=1e-4, atol=1e-7,
                                   err_msg=f"step {i}: {k}")


def _step(tree, i):
    """Step ``i`` of a tree of per-step stacks (a ``lax.scan``'s outputs)."""
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# spectral norm, discriminators, losses, VGG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["conv", "transpose", "conv3d"])
def test_spectral_norm_matches_flax(kind, train):
    """One power-iteration step from the stored u in both modes; only
    ``train`` (flax's ``update_stats``) stores the new u and sigma."""
    if kind == "conv":
        make_j = lambda: fnn.Conv(16, (3, 3), padding=1)
        port, shape, name = tb.Conv(12, 16, 3, 1, 1, snorm=True), (2, 8, 8, 12), "Conv_0"
    elif kind == "transpose":
        make_j = lambda: fnn.ConvTranspose(16, (3, 3), strides=(2, 2), padding="SAME")
        port, shape, name = tb.ConvTranspose(12, 16, snorm=True), (2, 8, 8, 12), \
            "ConvTranspose_0"
    else:
        make_j = lambda: fnn.Conv(16, (3, 3, 3), padding=1, use_bias=False)
        port, shape, name = td.Conv3d(12, 16, (3, 3, 3), (1, 1, 1), (1, 1, 1),
                                      snorm=True), (2, 3, 6, 6, 12), "Conv_0"

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x, train):
            return fnn.SpectralNorm(make_j())(x, update_stats=train)

    x = _x(shape, 1)
    values = _fill(jax.eval_shape(lambda: M().init(K(0), jnp.zeros(shape), False)),
                   np.random.default_rng(2))
    want, new = M().apply(_jnp(values), x, train, mutable=["batch_stats"])
    holder = _holder(**{name: port})
    load_flax(holder, values["params"], values["batch_stats"])
    got = port(_t(x), train)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5, atol=1e-5)
    _assert_stats(holder, new["batch_stats"])
    if not train:  # eval leaves the stored u as it was
        _assert_stats(holder, values["batch_stats"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the generator and the whole step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """numpy weights over the JAX shapes of the TINY generator (with the
    motion encoder), both discriminators and VGG, and a synthetic batch with
    N(0, 0.01^2) added to every pixel.  The synthetic frames are flat
    squares on a flat -1 background: their equal activations tie in d_t's
    max-pool windows, where torch and XLA route a tie's gradient to
    different elements, and where the generator's tanh output sits within
    rounding of -1 the L1 terms on frames and features (|fake - real|) take
    their sign from rounding.  Both are valid subgradients, but they part
    the JAX and port gradients of d_t's stem conv by 2e-3 and the
    generator's by a median 3e-3 per leaf; with the noise they agree to 5e-6
    and 6e-5 (measured on this CPU)."""
    model, disc_s, disc_t = jfs.build_first_stage(Config(_config(True)))
    mf_dt = tfs._dt_frames(TINY)
    shapes = jax.eval_shape(lambda: {
        "g": model.init({"params": K(0)}, jnp.zeros((1, T + 1, S, S, 3)),
                        rng=K(1), train=False),
        "dt": disc_t.init({"params": K(2)}, jnp.zeros((1, mf_dt, S, S, 3))),
        "ds": disc_s.init({"params": K(3)}, jnp.zeros((1, S, S, 3))),
        "vgg": jvgg.VGG19Features().init(K(4), jnp.zeros((1, 64, 64, 3)))})
    values = _fill(shapes, np.random.default_rng(11))
    batch = jax_make_batch(np.random.default_rng(0), batch_size=B, n_frames=T,
                           spatial_size=S)["images"]
    return values, batch + _x(batch.shape, 14, 1e-2)


def _port_nets(values, deterministic):
    cfg = _config(deterministic)
    with torch.device("meta"):
        nets = (*tfs.build_first_stage(cfg), tv.VGG19Features())
    nets = tuple(n.to_empty(device="cpu") for n in nets)
    for net, key in zip(nets, ("g", "ds", "dt", "vgg")):
        load_flax(net, values[key]["params"], values[key].get("batch_stats"))
    return nets


def test_generator_train_forward_matches_jax(tiny):
    """The train-mode forward (encoder noise from the same key, decoder
    frame by frame) and its new stats: every decoder u after T updates."""
    values, batch = tiny
    model = jfs.build_first_stage(Config(_config(False)))[0]
    g = _jnp(values["g"])
    fwd = jax.jit(lambda X, r: model.apply(g, X, rng=r, train=True,
                                           mutable=["batch_stats"]))
    (X_hat, mu, logvar), new = fwd(jnp.asarray(batch), K(12))
    noise = jax.random.normal(K(12), mu.shape)
    port = _port_nets(values, False)[0]
    got, got_mu, got_logvar = port(_t(batch), train=True, noise=_t(noise))
    for a, b in ((got_mu, mu), (got_logvar, logvar), (got, X_hat)):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), rtol=1e-4, atol=1e-4)
    assert _assert_stats(port, new["batch_stats"], rtol=1e-4, atol=1e-5) == 12


def _jax_draws(rng, cfg):
    """The JAX step's draws from its ``rng``, as ``sample_draws`` returns
    them."""
    r_enc, r_off, r_true, r_fake, _ = jax.random.split(rng, 5)
    n_ex, s = cfg["d_s"]["n_examples"], cfg["architecture"]["min_spatial_size"]
    hi = max(1, T + 1 - tfs._dt_frames(cfg))
    return {"noise": _t(jax.random.normal(r_enc, (B, s, s, cfg["architecture"]["z_dim"]))),
            "offset": int(jax.random.randint(r_off, (), 0, hi)),
            "idx_t": torch.tensor(np.asarray(jax.random.randint(
                r_true, (n_ex,), 0, B * (T + 1))), dtype=torch.long),
            "idx_f": torch.tensor(np.asarray(jax.random.randint(
                r_fake, (n_ex,), 0, B * T)), dtype=torch.long)}


def _jax_state(values, tx):
    v = _jnp(values)
    p = {k: v[k]["params"] for k in ("g", "ds", "dt")}
    return jfs.GANTrainState(
        params_g=p["g"], params_ds=p["ds"], params_dt=p["dt"],
        stats_g=v["g"]["batch_stats"], stats_ds=v["ds"]["batch_stats"],
        stats_dt=v["dt"]["batch_stats"], opt_g=tx.init(p["g"]),
        opt_ds=tx.init(p["ds"]), opt_dt=tx.init(p["dt"]),
        step=jnp.zeros((), jnp.int32))


def _per_net(state):
    """(params, stats, adam moments) of generator, d_s and d_t, as numpy."""
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return [(np_tree(p), np_tree(s), np_tree(o[1])) for p, s, o in (
        (state.params_g, state.stats_g, state.opt_g),
        (state.params_ds, state.stats_ds, state.opt_ds),
        (state.params_dt, state.stats_dt, state.opt_dt))]


def _like(net, tree, stats):
    """``net``'s parameters holding a flax tree of its shape (params,
    gradients or moments), in ``net.parameters()`` order."""
    ref = copy.deepcopy(net)
    load_flax(ref, tree, stats)
    return [t.detach() for t in ref.parameters()]


def _moments(tx):
    return [{k: s.clone() for k, s in tx.adam.state[q].items()} for q in tx.params]


def test_train_steps_match_jax(tiny):
    """Two steps of the jitted JAX step and of the port at disc_gate 1 then
    0, from the same weights, batch and draws (the JAX step's own keys),
    deterministic (motion = mu), at TINY's constant lr 1e-3.

    Step 1 runs from the same weights, step 2 from the same state: after
    step 1 JAX's params, stats and Adam moments are loaded into the port.
    Adam moves each entry by about lr whatever its gradient's size, so where
    a gradient entry is near zero its rounding sets the step's sign and two
    correct trainers part it by 2 lr (~0.05% of the entries here); carried
    into step 2, that moves step 2's losses by up to 1.3e-3 relative
    (loss_g_s, measured on this CPU).  After each step:

    * every metric within 1e-4 relative; every spectral norm's u and sigma
      (generator, d_s, d_t) within 1e-4;
    * params: every entry within 2 lr, and at most 1% of a net's entries
      more than lr / 10 apart (a wrong update parts all of them);
    * gradients, as Adam's first moments, by leaf norm within 3e-4 (1.3e-4
      seen) plus, per entry, 1e-4 of the RMS entry of the net's moments: the
      floor covers the biases that a one-channel-per-group norm cancels,
      whose gradient is rounding noise on the scale of the net's gradients;
    * step 1 moves every leaf; the gate-0 step leaves the discriminators'
      params and moments as they were and moves the generator."""
    values, batch = tiny
    cfg = _config(True)
    model, disc_s, disc_t = jfs.build_first_stage(Config(cfg))
    tx = joptim.gan_adam(LR)
    jstep = jax.jit(jfs.make_first_stage_train_step(
        Config(cfg), model, disc_s, disc_t, _jnp(values["vgg"]), tx, tx, tx))
    nets = _port_nets(values, True)
    txs = tfs.create_first_stage_state(*nets[:3], lambda ps: gan_adam(ps, LR))
    step = tfs.FirstStageStep(cfg, *nets, *txs)
    state = _jax_state(values, tx)
    for gate, key in ((1.0, K(20)), (0.0, K(21))):
        before = [[t.detach().clone() for t in net.parameters()] for net in nets[:3]]
        moments = [_moments(t) for t in txs]
        state, want = jstep(state, {"images": jnp.asarray(batch)}, key, gate)
        got = step({"images": _t(batch)}, _jax_draws(key, cfg), gate)
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
                g = g.detach()
                torch.testing.assert_close(g, w, rtol=0, atol=2 * LR, msg=name)
                off += int(((g - w).abs() > 0.1 * LR).sum())
            assert off <= 0.01 * sum(p.numel() for p in p0), (i, off)
            if gate == 0.0 and i > 0:  # the gated discriminators
                assert all(torch.equal(a, b) for a, b in zip(p0, net.parameters()))
                for a, b in zip(moments[i], _moments(t)):
                    assert all(torch.equal(a[k], b[k]) for k in a)
                continue
            assert all(not torch.equal(a, b) for a, b in zip(p0, net.parameters()))
            _assert_moments([t.adam.state[q]["exp_avg"] for q in t.params],
                            _like(net, adam.mu, stats), names)
        for net, (params, stats, adam), t in zip(nets[:3], _per_net(state), txs):
            load_flax(net, params, stats)  # the same state for the next step
            for key_t, key_j in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                for q, w in zip(t.params, _like(net, getattr(adam, key_j), stats)):
                    t.adam.state[q][key_t].copy_(w)
