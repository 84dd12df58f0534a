"""The port's bridge trainer (``ipoke_tpu_torch/train.py::FlowMotionTrainer``)
against the JAX package's ``make_flow_motion_train_step``, on CPU in fp32
at ``entry.FLOW_MOTION_TINY`` with the weights of
``tests/test_torch_third_stage.py``: two steps, the port given the JAX
step's own draws, each side computing its own target.  Per step: metrics
1e-4 relative; Adam's first moments 3e-4 by leaf norm (plus, per entry,
1e-4 of the RMS moment entry: ``tests/test_torch_first_stage.py``'s
rule); params within 2 lr a step (Adam's sign trap).  Also the trainer's schedule, recon weight and ``validate``.
The JAX side is one jitted program (``jax_ref``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.models import third_stage as jts
from ipoke_tpu_torch.train import FlowMotionTrainer, FlowVAETrainer

from test_torch_density import leaves
from test_torch_first_stage import _assert_metrics, _assert_moments, _step
from test_torch_ops import _jnp, _t
from test_torch_third_stage import (
    B,
    M,
    Z_TOTAL,
    _flow_input_draws,
    _port_vae,
    _tbatch,
    tiny,  # noqa: F401  (the shared weights fixture)
)

K = jax.random.PRNGKey
LR, BRIDGE_KEYS = 1e-3, (K(40), K(41))


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """The JAX side, one jitted program: two steps of the package's
    ``make_flow_motion_train_step`` as a ``lax.scan`` (its target the JAX
    second stage's ``forward_density``, with a deterministic first stage),
    each step also returning its params, first moments and draws.  The step
    splits its key into r1 (the flow input: eps and the extra channels), r2
    (the second stage's motion sample, unused: the first stage is
    deterministic) and r3 (the ``reference_nll_loss`` sample).
    ``flow_adam`` at a constant lr (AMSGrad, decay 1e-5)."""
    jmodel, frozen, values, _, batch = tiny

    @jax.jit
    def run(frozen, batch, inn, ss):
        tx = joptim.flow_adam(LR, params=inn)
        jstep = jts.make_flow_motion_train_step(jmodel, ss, tx)

        def step(state, key):
            r1, _, r3 = jax.random.split(key, 3)
            state, log = jstep(state, frozen, batch, key)
            draws = (*_flow_input_draws(r1),
                     jax.random.normal(r3, (B, M, M, Z_TOTAL), jnp.float32))
            mu = state.opt.inner_states["train"].inner_state[1].mu
            return state, (log, state.params, mu, draws)

        state = jts.ThirdStageState(params=inn, opt=tx.init(inn),
                                    step=jnp.zeros((), jnp.int32),
                                    weight_recon=jnp.asarray(1.0))
        return jax.lax.scan(step, state, jnp.stack(BRIDGE_KEYS))[1]

    out = run(frozen, _jnp(batch), {"inn": _jnp(values["inn"])},
              {"flow": _jnp(values["flow"])})
    return jax.tree_util.tree_map(np.asarray, out)


def test_bridge_steps_match_jax(tiny, jax_ref):
    """Two steps of ``FlowMotionTrainer`` (at a constant lr) against the
    JAX step, from the same weights, with the JAX step's draws.  Per step:
    every metric, the first moments of every bridge leaf and its params;
    the frozen nets stay as they were."""
    _, _, _, port, batch = tiny
    logs, params, mus, draws = jax_ref
    port = copy.deepcopy(port)
    frozen0 = [t.clone() for t in port.second_stage.parameters()] + \
        [t.clone() for t in port.flow_vae.parameters()]
    trainer = FlowMotionTrainer(port, LR)
    for i in range(len(BRIDGE_KEYS)):
        noise = tuple(_t(d[i]) for d in draws)
        _assert_metrics(trainer.train_step(_tbatch(batch), 0, noise=noise), logs, i)
        tree = port.inn_params.tree()
        tx = trainer.state.tx
        moment = {id(p): tx.adam.state[p]["exp_avg"].numpy() for p in tx.params}
        _assert_moments([moment[id(t)] for t in leaves(tree) if id(t) in moment],
                        jax.tree_util.tree_leaves(_step(mus, i)))
        for g, w in zip(leaves(tree), jax.tree_util.tree_leaves(_step(params, i))):
            np.testing.assert_allclose(g.detach().numpy(), w, atol=2 * LR * (i + 1),
                                       rtol=0)
    assert trainer.state.step == 2
    assert all(torch.equal(a, b) for a, b in zip(
        frozen0, [*port.second_stage.parameters(), *port.flow_vae.parameters()]))


def test_flow_motion_trainer_schedule_recon_weight_and_validate(tiny):
    """Without a schedule the trainer takes the config's, as
    ``FlowMotionExperiment.build`` does (warmup over ``lr_scaling_max_it``,
    linear decay to 0 over ``n_epochs * max_batches_per_epoch``); with
    ``recon_scaling`` its recon weight follows the epoch (x2 from epoch 9,
    without compounding over a batch's calls); ``validate`` gives the
    endpoint and angular errors of hallucinated flow (and the flow VAE's of
    its reconstruction)."""
    _, _, values, port, batch = tiny
    port = copy.deepcopy(port)
    port.config = dict(port.config, training={
        "recon_scaling": True, "weight_recon": 0.5, "lr": 2e-3,
        "lr_scaling_max_it": 5, "n_epochs": 3, "max_batches_per_epoch": 10})
    trainer = FlowMotionTrainer(port)
    want = joptim.warmup_linear_decay(2e-3, 5, 30)
    for count in (0, 3, 5, 17, 30, 40):
        np.testing.assert_allclose(trainer.state.tx.schedule(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
    gen = torch.Generator().manual_seed(0)
    for epoch, weight in ((8, 0.5), (9, 1.0), (9, 1.0), (19, 2.0)):
        log = trainer.train_step(_tbatch(batch), epoch, gen)
        assert trainer.state.weight_recon == weight
        assert all(np.isfinite(v.item()) for v in log.values())
    for metrics in (trainer.validate([_tbatch(batch)] * 2, gen),
                    FlowVAETrainer({"training": {}}, _port_vae(values)).validate(
                        [_tbatch(batch)])):
        assert metrics.keys() == {"EE-val", "AE-val"}
        assert all(np.isfinite(v) and v >= 0 for v in metrics.values())
