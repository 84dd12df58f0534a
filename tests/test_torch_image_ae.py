"""The port's image AE (``ipoke_tpu_torch.models.image_ae``) against the
JAX package's at a TINY width, on the CPU in fp32: the conditioner, with
its discriminator (no R1 penalty, as config/img_encoder.yaml; the penalty's
double backward is held in ``test_torch_first_stage.py``), takes two steps
(disc gate 1, then 0)
beside the jitted ``make_image_ae_train_step``, from the same weights
(carried by ``convert.load_image_ae``) and batch.  The poke embedder (no
discriminator) runs the same check in ``test_torch_cli_parity.py``, so
that each file compiles one JAX program."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core.config import Config
from ipoke_tpu.core.optim import gan_adam as jax_gan_adam
from ipoke_tpu.data.synthetic import make_batch
from ipoke_tpu.models import image_ae as jae
from ipoke_tpu.nn import PatchDiscriminator2D as JaxPatchDisc
from ipoke_tpu.nn.vgg import VGG19Features as JaxVGG
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax, load_image_ae
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import image_ae as tae
from ipoke_tpu_torch.nn.vgg import VGG19Features

from test_torch_first_stage import _assert_moments, _assert_stats
from test_torch_ops import _few_threads, _jnp  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill

K = jax.random.PRNGKey
S, LR = 16, 1e-3
CONFIGS = {
    "conditioner": {
        "data": {"spatial_size": (S, S)},
        "architecture": {"nf_in": 3, "nf_max": 16, "min_spatial_size": 4,
                         "deterministic": True},
        "training": {"perc_weight": 1.0, "disc_weight": 1.0},
        "disc": {"ndf": 8, "n_layers": 2, "gp_weight": 0.0},
        "input_key": "images", "target_key": "images"},
    "poke_embedder": {
        "data": {"spatial_size": (S, S)},
        "architecture": {"nf_in": 2, "nf_max": 16, "min_spatial_size": 4,
                         "deterministic": True},
        "training": {"perc_weight": 1.0},
        "input_key": "poke", "target_key": "flow"},
}


def _batch():
    """A synthetic batch with N(0, 0.01^2) added per entry: on flat frames
    VGG's max-pool ties make both sides' gradients hang on rounding."""
    rng = np.random.default_rng(3)
    b = make_batch(rng, batch_size=2, n_frames=2, spatial_size=S)
    return {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in b.items() if k in ("images", "poke", "flow")}


def _jax_state(cfg, model, disc, tx, use_disc):
    """The JAX package's initial state with random values from a numpy seed
    (``_fill`` over its shapes: tracing the init, not running it eagerly,
    which takes ~20 s on the CPU), ``logvar`` 0 as ``create_image_ae_state``
    sets it."""
    shapes = jax.eval_shape(lambda: jae.create_image_ae_state(
        K(0), cfg, model, disc, tx, tx, use_disc=use_disc))
    rng = np.random.default_rng(5)
    params = _jnp(dict(_fill({"ae": shapes.params["ae"]}, rng), logvar=np.float32(0)))
    params_d = _jnp(_fill(shapes.params_d, rng))
    return jae.AETrainState(
        params=params, params_d=params_d, stats=_jnp(_fill(shapes.stats, rng)),
        stats_d=_jnp(_fill(shapes.stats_d, rng)), opt=tx.init(params),
        opt_d=tx.init(params_d), step=jnp.zeros((), jnp.int32))


def _vgg():
    shapes = jax.eval_shape(lambda: JaxVGG().init(K(0), jnp.zeros((1, S, S, 3))))
    return _jnp(_fill(shapes, np.random.default_rng(6)))


def _like(module, tree, stats):
    """The values of a flax-layout tree (params, or a tree of their
    moments) in ``module.parameters()`` order."""
    ref = copy.deepcopy(module)
    load_flax(ref, tree, stats)
    return [t.detach() for t in ref.parameters()]


def _moments(tx):
    return [tx.adam.state[q]["exp_avg"].clone() if q in tx.adam.state
            else torch.zeros_like(q) for q in tx.params]


def _converted(kind, state, cfg, root):
    """The port's checkpoint state of the JAX ``state``: saved by the JAX
    package's store as a run of its experiment, converted by
    ``tools/jax_run_to_torch.py`` and restored by the port's store."""
    import os

    import yaml

    from ipoke_tpu.core.checkpoint import CheckpointStore as JStore
    from ipoke_tpu_torch.core.checkpoint import CheckpointStore
    from tools.jax_run_to_torch import convert_runs

    exp = {"conditioner": "img_encoder", "poke_embedder": "poke_encoder"}[kind]
    src, dst = os.path.join(root, "jax"), os.path.join(root, "port")
    JStore(os.path.join(src, exp, "ckpt", "toy", "0")).save(state, 0)
    os.makedirs(os.path.join(src, exp, "config", "toy"))
    with open(os.path.join(src, exp, "config", "toy", "0.yaml"), "w") as f:
        yaml.safe_dump(dict(copy.deepcopy(cfg), general={"experiment": exp}), f)
    assert convert_runs(src, dst, log=lambda line: None) == 1
    return CheckpointStore(os.path.join(dst, exp, "ckpt", "toy", "0")).restore()


def check_image_ae_steps(kind, via=None):
    """Two steps of the jitted JAX step and of the port, gates 1 then 0;
    after step 1 the JAX state is loaded into the port.  Per step: every
    metric within 1e-4 relative; every spectral norm's u and sigma within
    1e-4; params within 2 lr with at most 1% of the entries past lr / 10;
    Adam's first moments by the first-stage rule (3e-4 of the leaf norm).
    With ``via`` (a directory) JAX first takes one step of its own, and the
    port starts from that state converted as a JAX run (``_converted``),
    Adam's moments and count included: its next steps hold as above."""
    cfg = CONFIGS[kind]
    use_disc = kind == "conditioner"
    jcfg = Config(copy.deepcopy(cfg))
    model = jae.build_image_ae(jcfg)
    disc = JaxPatchDisc(ndf=8, n_layers=2)
    vgg = _vgg()
    tx = jax_gan_adam(LR)
    state = _jax_state(jcfg, model, disc, tx, use_disc)
    jstep = jax.jit(jae.make_image_ae_train_step(jcfg, model, disc, vgg, tx, tx,
                                                 use_disc=use_disc))

    with torch.device("meta"):
        port, pdisc = tae.build_image_ae(cfg), tae.build_image_disc(cfg)
    gen = torch.Generator().manual_seed(0)
    port = entry.materialize(port, "cpu", gen)
    pdisc = entry.materialize(pdisc, "cpu", gen) if use_disc else None
    pvgg = VGG19Features()
    load_flax(pvgg, vgg["params"])
    if via is None:
        load_image_ae(port, state.params, state.stats,
                      *((pdisc, state.params_d, state.stats_d) if use_disc else ()))
    else:
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in _batch().items()},
                         K(19), 1.0)
        converted = _converted(kind, state, cfg, via)
        port.load_state_dict(converted["model"])
        if use_disc:
            pdisc.load_state_dict(converted["disc"])
    ptx, ptx_d = tae.create_image_ae_state(port, pdisc, lambda ps: gan_adam(ps, LR),
                                           use_disc=use_disc)
    if via is not None:
        ptx.load_state_dict(converted["tx"])
        if use_disc:
            ptx_d.load_state_dict(converted["tx_d"])
        assert ptx.count == int(state.opt[1].count) == 1
    step = tae.make_image_ae_train_step(cfg, port, pdisc, pvgg, ptx, ptx_d, use_disc)
    batch = _batch()
    nets = [(port, ptx, "params", "stats", "opt")]
    if use_disc:
        nets.append((pdisc, ptx_d, "params_d", "stats_d", "opt_d"))
    for gate, key in ((1.0, K(20)), (0.0, K(21))):
        before = [[q.detach().clone() for q in t.params] for _, t, *_ in nets]
        moments = [_moments(t) for _, t, *_ in nets]
        state, want = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            key, gate)
        got = step({k: torch.as_tensor(v) for k, v in batch.items()}, gate)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{kind} gate {gate}: {k}")
        for i, ((net, t, pk, sk, ok), p0) in enumerate(zip(nets, before)):
            params, stats = getattr(state, pk), getattr(state, sk)
            mu = getattr(state, ok)[1].mu
            if i == 0:  # {'ae', 'logvar'}
                want_p = _like(net.ae, params["ae"], stats) + [
                    torch.tensor(np.asarray(params["logvar"]))]
                want_mu = _like(net.ae, mu["ae"], stats) + [
                    torch.tensor(np.asarray(mu["logvar"]))]
                _assert_stats(net.ae, stats, rtol=1e-4, atol=1e-4)
            else:
                want_p, want_mu = _like(net, params, stats), _like(net, mu, stats)
                _assert_stats(net, stats, rtol=1e-4, atol=1e-4)
            off = 0
            for g, w in zip(t.params, want_p):
                torch.testing.assert_close(g.detach(), w, rtol=0, atol=2 * LR)
                off += int(((g.detach() - w).abs() > 0.1 * LR).sum())
            assert off <= 0.01 * sum(p.numel() for p in p0), (kind, i, off)
            if gate == 0.0 and i == 1:  # the gated discriminator stays
                assert all(torch.equal(a, b) for a, b in zip(p0, t.params))
                assert all(torch.equal(a, b) for a, b in zip(moments[i], _moments(t)))
                continue
            # a leaf moves exactly where JAX's moves (the last conv's bias
            # can have a zero gradient under the hinge loss)
            assert [torch.equal(a, b) for a, b in zip(p0, t.params)] == \
                [torch.equal(a, w) for a, w in zip(p0, want_p)], (kind, gate, i)
            assert not all(torch.equal(a, b) for a, b in zip(p0, t.params))
            _assert_moments(_moments(t), want_mu)
        # the same state for the next step
        load_image_ae(port, state.params, state.stats,
                      *((pdisc, state.params_d, state.stats_d) if use_disc else ()))
        for net, t, pk, sk, ok in nets:
            adam = getattr(state, ok)[1]
            layout = (lambda tree: _like(net.ae, tree["ae"], state.stats)
                      + [torch.tensor(np.asarray(tree["logvar"]))]) \
                if net is port else (lambda tree: _like(net, tree, state.stats_d))
            for key_t, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                for q, w in zip(t.params, layout(tree)):
                    t.adam.state[q][key_t].copy_(w)


def test_conditioner_steps_match_jax():
    check_image_ae_steps("conditioner")


def test_freeze_spectral_norm_is_flax_eval():
    """A frozen copy (spectral norm collapsed) reconstructs as the live net
    does in eval mode, and has no u or sigma left."""
    cfg = CONFIGS["conditioner"]
    with torch.device("meta"):
        net = tae.build_image_ae(cfg).ae
    net = entry.materialize(net, "cpu", torch.Generator().manual_seed(1))
    frozen = tae.freeze_spectral_norm(copy.deepcopy(net))
    assert not any(k.endswith((".u", ".sigma")) for k in frozen.state_dict())
    x = torch.randn(2, S, S, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(frozen(x), net(x, train=False), rtol=1e-5, atol=1e-6)


def test_kl_conv_matches_jax():
    rng = np.random.default_rng(7)
    mu, logstd = rng.standard_normal((2, 2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tae.kl_conv(torch.tensor(mu), torch.tensor(logstd)).item(),
        float(jae.kl_conv(jnp.asarray(mu), jnp.asarray(logstd))), rtol=1e-6)
