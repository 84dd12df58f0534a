"""The port's BigAE and FCAE step (``models/big_ae.py``, ``models/fc_stack.py``)
against the JAX package's, fp32 on the CPU, with the same weights carried
by ``convert.load_flax``: encode and decode (the conditional batch norm on
batch statistics, SAGAN attention, z padding and chunks) within 1e-4 at
32 px, ``gen_ch`` 8 (``entry.FC_TINY``), on flow maps (2 channels) and frames (3);
``gaussian_kl`` within 1e-6; and two FCAE steps (discriminator factor 1,
then 0) against the JAX package's ``make_fcae_train_step`` from the same
state, by ``tests/test_torch_first_stage.py``'s rule: metrics within 1e-4,
every param within 2 lr with at most 1% of a net's entries past lr / 10,
gradients as Adam's first moments by leaf norm, every discriminator u;
the factor-0 step leaves the discriminator as it was.  The steps run on
flow maps, against the jitted JAX step (this file's one compiled program;
the image BigAE differs from it only in its input key, without VGG's
padding: ``test_fcae_step_takes_the_first_frame``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.models import big_ae as jbig
from ipoke_tpu.models import fc_stack as jfc
from ipoke_tpu.nn import discriminators as jd
from ipoke_tpu.nn import vgg as jvgg
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import big_ae as tbig
from ipoke_tpu_torch.models import fc_stack as tfc
from ipoke_tpu_torch.nn import discriminators as td
from ipoke_tpu_torch.nn import vgg as tv

from test_torch_first_stage import _assert_moments, _assert_stats, _like
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill, _x

K = jax.random.PRNGKey
FE = entry.FC_TINY["flow_encoder"]
S, B, LR = FE["data"]["spatial_size"][0], 2, FE["training"]["lr"]
Z = FE["architecture"]["z_dim"]  # 10, padded to 12: 4 chunks of 3


def _config(channels):
    cfg = copy.deepcopy(entry.FC_TINY["flow_encoder"])
    cfg["architecture"]["n_out_channels"] = channels
    return cfg


def _nets(channels):
    """The JAX BigAE, discriminator and VGG, numpy weights over their
    shapes (``_fill``: fan-in kernels, norms and biases off their init,
    attention's gamma non-zero) and the port's nets holding them."""
    cfg = _config(channels)
    model = jfc.build_big_ae(Config(cfg))
    disc = jd.PatchDiscriminator2D(ndf=8, n_layers=2)
    shapes = jax.eval_shape(lambda: {
        "g": model.init({"params": K(0)}, jnp.zeros((1, S, S, channels)), rng=K(1)),
        "d": disc.init({"params": K(2)}, jnp.zeros((1, S, S, channels)), train=False),
        "vgg": jvgg.VGG19Features().init(K(3), jnp.zeros((1, 64, 64, 3)))})
    values = _fill(shapes, np.random.default_rng(20 + channels))
    with torch.device("meta"):
        nets = (tfc.build_big_ae(cfg), td.PatchDiscriminator2D(8, 2, cin=channels),
                tv.VGG19Features())
    nets = tuple(n.to_empty(device="cpu") for n in nets)
    for net, key in zip(nets, ("g", "d", "vgg")):
        load_flax(net, values[key]["params"], values[key].get("batch_stats"))
    return cfg, (model, disc), values, nets


def _input(channels, seed):
    x = np.tanh(_x((B, S, S, channels), seed))
    return {"flow": x} if channels == 2 else {"images": x[:, None]}


@pytest.mark.parametrize("channels", [2, 3])
def test_big_ae_matches_flax(channels):
    """encode (mu, logvar) and decode of the posterior sample with the JAX
    draw, eagerly."""
    cfg, (model, _), values, (port, _, _) = _nets(channels)
    x = _x((B, S, S, channels), 30)
    g = {"params": _jnp(values["g"]["params"])}
    with jax.disable_jit():
        rec, mu, logvar = model.apply(g, jnp.asarray(x), rng=K(31))
    noise = jax.random.normal(K(31), mu.shape)
    got, got_mu, got_logvar = port(_t(x), _t(noise))
    for a, b in ((got_mu, mu), (got_logvar, logvar), (got, rec)):
        np.testing.assert_allclose(a.detach().numpy(), _np(b), rtol=1e-4, atol=1e-4)
    assert port.gen_z_dim == 12 and got.shape == (B, S, S, channels)
    np.testing.assert_allclose(port.decode(got_mu).detach().numpy(),
                               _np(model.apply(g, mu, method=jbig.BigAE.decode)),
                               rtol=1e-4, atol=1e-4)


def test_gaussian_kl_matches_jax():
    mu, logvar = _x((B, Z), 32), _x((B, Z), 33)
    np.testing.assert_allclose(tbig.gaussian_kl(_t(mu), _t(logvar)).item(),
                               float(jbig.gaussian_kl(jnp.asarray(mu), jnp.asarray(logvar))),
                               rtol=1e-6)


def _check_net(name, net, tx, p0, m0, params, stats, adam, gated):
    """The port's net after a step against the JAX state's, by the rule of
    the module docstring."""
    if stats:
        _assert_stats(net, stats, rtol=1e-4, atol=1e-4)
    names = [n for n, _ in net.named_parameters()]
    off = 0
    for n, g, w in zip(names, net.parameters(), _like(net, params, stats)):
        torch.testing.assert_close(g.detach(), w, rtol=0, atol=2 * LR, msg=f"{name} {n}")
        off += int(((g.detach() - w).abs() > 0.1 * LR).sum())
    assert off <= 0.01 * sum(p.numel() for p in p0), (name, off)
    if gated:
        assert all(torch.equal(a, b) for a, b in zip(p0, net.parameters()))
        for a, q in zip(m0, tx.params):
            assert all(torch.equal(a[k], tx.adam.state[q][k]) for k in a)
        return
    assert all(not torch.equal(a, b) for a, b in zip(p0, net.parameters()))
    _assert_moments([tx.adam.state[q]["exp_avg"] for q in tx.params],
                    _like(net, adam.mu, stats), names)


def test_fcae_steps_match_jax():
    """Two steps at discriminator factor 1 then 0 from the same state
    (after step 1, JAX's params, u, Adam moments and previous d_loss are
    loaded into the port)."""
    channels = 2
    cfg, (model, disc), values, (port, pdisc, vgg) = _nets(channels)
    tx = joptim.gan_adam(LR)
    run = jax.jit(jfc.make_fcae_train_step(Config(cfg), model, disc, _jnp(values["vgg"]),
                                           tx, tx))
    v = _jnp(values)
    state = jfc.FCAETrainState(
        params=v["g"]["params"], params_d=v["d"]["params"], stats_d=v["d"]["batch_stats"],
        opt=tx.init(v["g"]["params"]), opt_d=tx.init(v["d"]["params"]),
        prev_d_loss=jnp.zeros(()), step=jnp.zeros((), jnp.int32))
    txs = [gan_adam(list(n.parameters()), LR) for n in (port, pdisc)]
    port_step = tfc.FCAEStep(cfg, port, pdisc, vgg, *txs)
    batch = _input(channels, 34)
    for factor, key in ((1.0, K(40)), (0.0, K(41))):
        before = [[p.detach().clone() for p in n.parameters()] for n in (port, pdisc)]
        moments = [[{k: s.clone() for k, s in t.adam.state[q].items()} for q in t.params]
                   for t in txs]
        state, want = run(state, _jnp(batch), key, factor)
        noise = jax.random.normal(key, (B, Z))
        got = port_step({k: _t(x) for k, x in batch.items()}, factor, _t(noise))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"factor {factor}: {k}")
        gated = factor == 0.0
        assert gated == (float(want["d_loss"]) <= 0)
        np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
        _check_net("BigAE", port, txs[0], before[0], moments[0], np_(state.params), None,
                   np_(state.opt[1]), False)
        _check_net("disc", pdisc, txs[1], before[1], moments[1], np_(state.params_d),
                   np_(state.stats_d), np_(state.opt_d[1]), gated)
        # the same state for the next step
        for net, tree, stats, t, adam in (
                (port, state.params, None, txs[0], state.opt[1]),
                (pdisc, state.params_d, state.stats_d, txs[1], state.opt_d[1])):
            load_flax(net, np_(tree), np_(stats) if stats is not None else None)
            for key_t, key_j in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                for q, w in zip(t.params, _like(net, np_(getattr(adam, key_j)),
                                                np_(stats) if stats is not None else None)):
                    t.adam.state[q][key_t].copy_(w)
        port_step.prev_d_loss = torch.tensor(float(state.prev_d_loss))


def test_fcae_step_takes_the_first_frame():
    """On frames the step trains on each clip's first frame: a clip batch
    and its first frames give the same metrics and updates."""
    cfg, _, _, nets = _nets(3)
    clip = _t(_input(3, 35)["images"].repeat(2, axis=1))
    clip[:, 1] += 0.5
    out = []
    for batch in ({"images": clip}, {"images": clip[:, 0].clone()}):
        port, pdisc, vgg = copy.deepcopy(nets)
        step = tfc.FCAEStep(cfg, port, pdisc, vgg,
                            *(gan_adam(list(n.parameters()), LR) for n in (port, pdisc)))
        metrics = step(batch, 1.0, torch.zeros(B, Z))
        out.append((metrics, [p.detach() for p in port.parameters()]))
    (m0, p0), (m1, p1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0) and m0["rec_loss"] > 0
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_fcae_trainer_draws_and_disc_start():
    """``FCAETrainer``: the discriminator's factor from ``disc.start``, the
    posterior noise (B, z_dim) from the caller's generator."""
    cfg = dict(_config(2), disc={"ndf": 8, "n_layers": 2, "start": 1})
    with torch.device("meta"):
        model, disc, vgg = (tfc.build_big_ae(cfg), td.PatchDiscriminator2D(8, 2, cin=2),
                            tv.VGG19Features())
    trainer = tfc.FCAETrainer(cfg, model, disc, vgg, None, None)
    seen = []
    trainer.step = lambda batch, factor, noise: seen.append((factor, noise)) or {}
    trainer.step.key = "flow"
    x = torch.zeros(B, S, S, 2)
    for epoch in (0, 1):
        trainer.train_step({"flow": x}, epoch, torch.Generator().manual_seed(5))
    assert [f for f, _ in seen] == [0.0, 1.0]
    assert seen[0][1].shape == (B, Z) and torch.equal(seen[0][1], seen[1][1])
