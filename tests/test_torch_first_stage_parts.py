"""The port's first-stage VAE-GAN parts (ipoke_tpu_torch) against the JAX
package's, on CPU in fp32 at the TINY config of ``tests/test_first_stage.py``
(the whole step against the jitted JAX step: ``tests/test_torch_first_stage.py``):
both discriminators, the gradient penalty and its double backward, the
losses, VGG, ``gan_adam`` against optax, the unported branches, the
trainer's gates and schedule, and the rule that holds the card's step
against the CPU's held fp32 against float64, with the same weights
(carried by ``convert.load_flax``) and inputs from numpy seeds."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.nn import discriminators as jd
from ipoke_tpu.nn import vgg as jvgg
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import first_stage as tfs
from ipoke_tpu_torch.nn import discriminators as td
from ipoke_tpu_torch.nn import vgg as tv

from test_torch_first_stage import LR, TINY, B, K, S, _assert_moments, _assert_stats
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill, _x


def _disc(kind):
    """(flax disc, port disc, input shape) at the TINY widths."""
    if kind == "2d":
        cfg = TINY["d_s"]
        return (jd.PatchDiscriminator2D(ndf=cfg["ndf"], n_layers=cfg["n_layers"]),
                td.PatchDiscriminator2D(cfg["ndf"], cfg["n_layers"]), (4, S, S, 3))
    return (jd.ResNet3DDiscriminator(layers=tuple(TINY["d_t"]["layers"])),
            td.ResNet3DDiscriminator(tuple(TINY["d_t"]["layers"])), (B, 3, S, S, 3))


def _carried_disc(kind, seed):
    jdisc, port, shape = _disc(kind)
    values = _fill(jax.eval_shape(lambda: jdisc.init(K(0), jnp.zeros(shape))),
                   np.random.default_rng(seed))
    load_flax(port, values["params"], values["batch_stats"])
    return jdisc, port, shape, _jnp(values)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_discriminator_matches_flax(kind, train):
    """Logits, every feature map and the new u of every spectral norm."""
    jdisc, port, shape, values = _carried_disc(kind, 3)
    x = _x(shape, 4)
    (logits, fmaps), new = jdisc.apply(values, x, train=train, mutable=["batch_stats"])
    got_logits, got_fmaps = port(_t(x), train)
    np.testing.assert_allclose(got_logits.detach().numpy(), _np(logits),
                               rtol=1e-4, atol=1e-5)
    assert len(got_fmaps) == len(fmaps)
    for g, w in zip(got_fmaps, fmaps):
        np.testing.assert_allclose(g.detach().numpy(), _np(w), rtol=1e-4, atol=1e-5)
    _assert_stats(port, new["batch_stats"])


def test_gradient_penalty_matches_jax_grad():
    """The R1 penalty of the 3D disc per sample against ``jax.grad``, and
    its mean's gradient in the disc's params (the double backward) against
    ``jax.grad`` of it, leaf by leaf."""
    jdisc, port, shape, values = _carried_disc("3d", 5)
    x = _x(shape, 6)

    def jgp(params):
        apply = lambda v: jdisc.apply({"params": params,
                                       "batch_stats": values["batch_stats"]}, v)[0]
        return jd.gradient_penalty(apply, jnp.asarray(x))

    want, want_grads = jax.jit(lambda p: (jgp(p), jax.grad(
        lambda q: jnp.mean(jgp(q)))(p)))(values["params"])
    got = td.gradient_penalty(lambda v: port(v)[0], _t(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-4)
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(got.mean(), params)
    ref = copy.deepcopy(port)
    load_flax(ref, jax.tree_util.tree_map(np.asarray, want_grads),
              values["batch_stats"])
    for name, g, w in zip(names, grads, ref.parameters()):
        w = w.detach().numpy()
        assert np.linalg.norm(g.numpy() - w) <= 1e-4 * np.linalg.norm(w), name


def test_gan_losses_match_jax():
    """hinge (real, fake), BCE, generator (hinge and BCE), feature matching
    (L1 and L2), KL and the adaptive weight."""
    rng = np.random.default_rng(7)
    pred = rng.standard_normal((4, 6, 6, 1)).astype(np.float32) * 2
    fa = [rng.standard_normal((2, 4, 4, c)).astype(np.float32) for c in (8, 16)]
    fb = [rng.standard_normal(f.shape).astype(np.float32) for f in fa]
    mu = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    logvar = 0.5 * rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    p, tfa, tfb = _t(pred), [_t(f) for f in fa], [_t(f) for f in fb]
    pairs = [(td.hinge_d_loss(p, r), jd.hinge_d_loss(pred, r)) for r in (True, False)]
    pairs += [(td.bce_d_loss(p, r), jd.bce_d_loss(pred, r)) for r in (True, False)]
    pairs += [(td.gen_loss(p, bce), jd.gen_loss(pred, bce)) for bce in (False, True)]
    pairs += [(td.fmap_loss(tfa, tfb, l), jd.fmap_loss(fa, fb, l)) for l in ("l1", "l2")]
    pairs.append((tfs.kl_loss(_t(mu), _t(logvar)), jfs.kl_loss(mu, logvar)))
    pairs.append((td.adaptive_disc_weight(torch.tensor(3.0), torch.tensor(0.2)),
                  jd.adaptive_disc_weight(3.0, 0.2)))
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_vgg_loss_matches_jax():
    """The perceptual loss, mean and weighted, with VGG's params carried."""
    shapes = jax.eval_shape(
        lambda: jvgg.VGG19Features().init(K(0), jnp.zeros((1, S, S, 3))))
    values = _fill(shapes, np.random.default_rng(8))
    vgg = tv.VGG19Features()
    load_flax(vgg, values["params"])
    x, y = np.tanh(_x((3, S, S, 3), 9)), np.tanh(_x((3, S, S, 3), 10))
    for weighted in (False, True):
        want = jvgg.vgg_loss(_jnp(values), x, y, weighted)
        got = tv.vgg_loss(vgg, _t(x), _t(y), weighted)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

def test_gan_adam_matches_optax():
    """``gan_adam`` against the JAX package's (optax chain: decayed weights,
    Adam with betas (0.5, 0.9), the staircase schedule) over 5 updates of
    the same gradients, some entries with zero gradient (decay only)."""
    from ipoke_tpu_torch.core.optim import exp_decay_per_epoch

    rng = np.random.default_rng(13)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * (k % 2) for p in p0]
             for k in range(5)]
    tx = joptim.gan_adam(joptim.exp_decay_per_epoch(1e-2, 0.5, 2), 1e-2)
    params, opt = [jnp.asarray(p) for p in p0], None
    opt = tx.init(params)
    port = [torch.tensor(p) for p in p0]
    ptx = gan_adam(port, exp_decay_per_epoch(1e-2, 0.5, 2), 1e-2)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(x) for x in g], opt, params)
        params = [a + u for a, u in zip(params, upd)]
        for q, x in zip(port, g):
            q.grad = torch.tensor(x)
        ptx.step()
        for a, q in zip(params, port):
            np.testing.assert_allclose(q.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_build_first_stage_refuses_unported_branches():
    """The PokeVAE branch and bf16 mixed_prec name their queue (the FC
    baseline is ported: ``tests/test_torch_fc_baseline.py``)."""
    for section, key in (("architecture", "baseline"), ("training", "mixed_prec")):
        cfg = copy.deepcopy(TINY)
        cfg[section][key] = True
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            tfs.build_first_stage(cfg)


def test_trainer_gates_and_schedule():
    """``FirstStageTrainer``: disc gate from ``d_t.pretrain``, the KL ramp
    over ``kl_annealing`` epochs, and the staircase lr per optimizer at the
    updates it has made (a gated optimizer's schedule waits)."""
    from ipoke_tpu_torch.core.optim import exp_decay_per_epoch
    from ipoke_tpu_torch.train import FirstStageTrainer

    cfg = copy.deepcopy(TINY)
    cfg["d_t"]["pretrain"], cfg["training"]["kl_annealing"] = 2, 4
    cfg["training"].update(max_batches_per_epoch=3, gamma=0.5)
    with torch.device("meta"):
        nets = (*tfs.build_first_stage(cfg), tv.VGG19Features())
    trainer = FirstStageTrainer(cfg, *nets)
    assert trainer.gates(0) == (0.0, 0.25) and trainer.gates(1) == (0.0, 0.5)
    assert trainer.gates(2) == (1.0, 0.75) and trainer.gates(5) == (1.0, 1.0)
    sched = exp_decay_per_epoch(1e-3, 0.5, 3)
    assert [sched(c) for c in (0, 2, 3, 7)] == [1e-3, 1e-3, 5e-4, 2.5e-4]
    for tx in trainer.tx:
        assert [tx.schedule(c) for c in range(10)] == [sched(c) for c in range(10)]
    jsched = joptim.exp_decay_per_epoch(1e-3, 0.5, 3)
    np.testing.assert_allclose([sched(c) for c in range(10)],
                               [float(jsched(c)) for c in range(10)], rtol=1e-6)

def test_step_fp32_holds_card_rule_against_float64():
    """The rule that holds the card's first-stage step against the CPU's
    (``chip_smoke.py`` (i2), ``test_torch_cuda.py``) leaves room for fp32
    rounding: on the CPU, 3 fp32 steps against float64 ones, each from the
    fp32 side's state, on the same TINY weights, plain synthetic batch and
    draws as (i2), lr 1e-3.  Per step: every metric within 1e-3 of 1 +
    |float64|; each net's params within 2 lr, at most 1% of them more than
    lr / 10 apart; Adam's first moments by leaf norm within 3e-4 plus 1e-4
    of the net's RMS moment per entry."""
    cfg = TINY
    nets = entry.build_first_stage(cfg, "cpu", torch.Generator().manual_seed(0))
    images = entry.make_first_stage_batch(cfg, "cpu")["images"]
    draw_gen = torch.Generator().manual_seed(1)
    steps = []
    for dt in (torch.float32, torch.float64):
        ns = [copy.deepcopy(n).to(dt) for n in nets]
        txs = tfs.create_first_stage_state(*ns[:3], lambda ps: gan_adam(ps, LR))
        steps.append((ns, txs, tfs.FirstStageStep(cfg, *ns, *txs)))
    (ns32, txs32, step32), (ns64, txs64, step64) = steps
    for i in range(3):
        draws = tfs.sample_draws(draw_gen, cfg, cfg["data"]["batch_size"])
        got = step32({"images": images}, draws, 1.0)
        want = step64({"images": images.double()},
                      {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
                       else v for k, v in draws.items()}, 1.0)
        for k in want:
            assert abs(got[k].item() - want[k].item()) <= 1e-3 * (1 + abs(want[k].item())), (i, k)
        for a, b, ta, tb in zip(ns32[:3], ns64[:3], txs32, txs64):
            d = [(p.detach().double() - q.detach()).abs()
                 for p, q in zip(a.parameters(), b.parameters())]
            assert max(x.max() for x in d) <= 2 * LR, i
            assert sum(int((x > 0.1 * LR).sum()) for x in d) <= 0.01 * sum(x.numel() for x in d)
            _assert_moments([ta.adam.state[q]["exp_avg"].double() for q in ta.params],
                            [tb.adam.state[q]["exp_avg"] for q in tb.params])
            b.load_state_dict(a.state_dict())  # the next step from one state
            for qa, qb in zip(ta.params, tb.params):
                for k, v in ta.adam.state[qa].items():
                    tb.adam.state[qb][k].copy_(v)
