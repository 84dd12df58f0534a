"""The port's conv flow VAE (``ipoke_tpu_torch/models/third_stage.py::
ConvFlowVAE``, ``train.py::FlowVAETrainer``) against the JAX package's, on
CPU in fp32 at ``entry.FLOW_MOTION_TINY``'s sizes (``tests/
test_third_stage.py``'s: 32 px, 4 latent channels, nf_max 16, min spatial
4), with the same weights (numpy values over the flax shapes, random
spectral-norm u, carried by ``convert.load_flax``) and the JAX functions'
own draws handed to the port as tensors:

* encode (z, mu, logvar) and decode in eval mode: 1e-4;
* two ``FlowVAETrainer`` steps against ``FlowVAEExperiment``'s step:
  metrics 1e-4 relative, every spectral norm's u and sigma 1e-4, params
  within 2 lr a step (Adam's sign trap), Adam's first moments 3e-4 by leaf
  norm (plus, per entry, 1e-4 of the RMS moment entry:
  ``tests/test_torch_first_stage.py``'s rule).

The JAX side is one jitted program (``jax_ref``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.models import third_stage as jts
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.models import third_stage as tts
from ipoke_tpu_torch.train import FlowVAETrainer

from test_torch_first_stage import (
    _assert_metrics,
    _assert_moments,
    _assert_stats,
    _like,
    _step,
)
from test_torch_ops import _jnp, _t
from test_torch_sampling import _fill, _x

K = jax.random.PRNGKey
CFG = entry.FLOW_MOTION_TINY
S, M = CFG["second_stage"]["spatial"], CFG["second_stage"]["min_spatial"]
Z_FLOW, B = CFG["architecture"]["flow_vae_channels"], 2
LR, KL_WEIGHT = 1e-3, 1e-6
ENCODE_KEY, VAE_KEYS = K(8), (K(50), K(51))
VAE_ARGS = (S, Z_FLOW, CFG["architecture"]["flow_vae_nf_max"], M)


def _port_vae(values):
    vae = tts.ConvFlowVAE(*VAE_ARGS)
    load_flax(vae, values["params"], values["batch_stats"])
    return vae


@pytest.fixture(scope="module")
def jax_ref():
    """numpy weights over the flax shapes, and the JAX side, one jitted
    program: ``encode`` (with a key) and ``decode``; two steps of
    ``FlowVAEExperiment``'s step (a closure of the experiment, rebuilt from
    its body: ``optax.adam``, MSE + kl_weight * KL, ``mutable=
    ["batch_stats"]``) as a ``lax.scan``."""
    fv = jts.ConvFlowVAE(*VAE_ARGS)
    values = _fill(jax.eval_shape(lambda: fv.init(
        {"params": K(5)}, jnp.zeros((1, S, S, 2)), rng=K(6))), np.random.default_rng(22))
    x, flow = _x((B, S, S, 2), 31, 2.0), _x((B, S, S, 2), 33, 2.0)

    def loss_fn(p, stats, rng):
        (rec, mu, logvar), new_vars = fv.apply(
            {"params": p, "batch_stats": stats}, flow, rng=rng, train=True,
            mutable=["batch_stats"])
        rec_l = jnp.mean((rec - flow) ** 2)
        kl = -0.5 * jnp.mean(jnp.sum(1.0 + logvar - mu ** 2 - jnp.exp(logvar), axis=-1))
        loss = rec_l + KL_WEIGHT * kl
        return loss, ({"loss": loss, "rec_loss": rec_l, "kl_loss": kl},
                      new_vars["batch_stats"])

    def step(tx):
        def run(carry, key):
            params, stats, opt = carry
            (_, (log, stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, stats, key)
            upd, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, upd)
            eps = jax.random.normal(key, (B, M, M, Z_FLOW), jnp.float32)
            return (params, stats, opt), (log, stats, params, opt[0].mu, eps)
        return run

    @jax.jit
    def run(v, x):
        enc = fv.apply(v, x, rng=ENCODE_KEY, method=jts.ConvFlowVAE.encode)
        tx = optax.adam(LR)
        steps = jax.lax.scan(step(tx), (v["params"], v["batch_stats"],
                                         tx.init(v["params"])), jnp.stack(VAE_KEYS))[1]
        return {"enc": enc, "dec": fv.apply(v, enc[0], method=jts.ConvFlowVAE.decode),
                "enc_eps": jax.random.normal(ENCODE_KEY, (B, M, M, Z_FLOW), jnp.float32),
                "steps": steps}

    out = run(_jnp(values), jnp.asarray(x))
    return values, jax.tree_util.tree_map(np.asarray, out), x, flow


def test_flow_vae_encode_decode_match_flax(jax_ref):
    """encode (z from JAX's draw, mu, logvar; z = mu without noise) and
    decode in eval mode: the power-iteration step from the stored u, not
    stored."""
    values, ref, x, _ = jax_ref
    vae = _port_vae(values)
    with torch.no_grad():
        got = vae.encode(_t(x), noise=_t(ref["enc_eps"]))
        dec = vae.decode(_t(ref["enc"][0]))
        assert torch.equal(vae.encode(_t(x))[0], got[1])
    assert got[0].shape == (B, M, M, Z_FLOW) and dec.shape == (B, S, S, 2)
    for g, w in zip((*got, dec), (*ref["enc"], ref["dec"])):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


def test_flow_vae_steps_match_jax(jax_ref):
    """Two steps of ``FlowVAETrainer`` against ``FlowVAEExperiment``'s step,
    with JAX's encoder draw: metrics, every spectral norm's u and sigma
    (advanced once a step), params, first moments."""
    values, ref, _, flow = jax_ref
    logs, stats, params, mus, eps = ref["steps"]
    vae = _port_vae(values)
    trainer = FlowVAETrainer({"training": {"lr": LR, "kl_weight": KL_WEIGHT}}, vae)
    for i in range(len(VAE_KEYS)):
        _assert_metrics(trainer.train_step({"flow": _t(flow)}, noise=_t(eps[i])), logs, i)
        st = _step(stats, i)
        assert _assert_stats(vae, st, rtol=1e-4, atol=1e-4) > 0
        for p, w in zip(vae.parameters(), _like(vae, _step(params, i), st)):
            torch.testing.assert_close(p.detach(), w, rtol=0, atol=2 * LR * (i + 1))
        _assert_moments([trainer.tx.adam.state[p]["exp_avg"].numpy()
                         for p in vae.parameters()],
                        [w.numpy() for w in _like(vae, _step(mus, i), st)])
