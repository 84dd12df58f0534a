"""The second stage's 30-step fp32 NLL trajectory under Adafactor and
AdaBelief (``training.use_adafactor`` / ``use_adabelief``), the port's
``SecondStageTrainer`` against the JAX package's loss and gradient (one
jitted program) with ``flow_adam``'s optax chain applied outside it (a
small jitted program of its own a rule), at the toy config of
``tests/test_torch_train.py``.  The flow
starts from the port's DDI on the batch, perturbed (DDI leaves every
coupling an identity), on both sides."""

import jax
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.flows import flow_loss as jflow_loss
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import flow_params, load_flax, to_numpy_tree
from ipoke_tpu_torch.train import SecondStageTrainer

from test_torch_ops import _few_threads, _jnp, _perturb, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill
from test_torch_train import LR, TOY, TRAJECTORY_RTOL, _jax_model
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models.second_stage import FrozenBundle

K = jax.random.PRNGKey
STEPS = 30


def _port(values, flow):
    port = entry.make_model(TOY, flow_params(flow))
    for sub, name in ((port.first_stage, "fs"), (port.conditioner, "cond"),
                      (port.poke_embedder, "poke")):
        load_flax(sub, values[name]["params"], values[name].get("batch_stats"))
    port.config["training"]["mixed_prec_master"] = False  # fp32
    return port


@pytest.fixture(scope="module")
def start():
    """numpy weights over the JAX shapes, the flow from the port's DDI on
    the batch then perturbed, the batch, and the JAX loss-and-gradient."""
    jmodel, shapes = _jax_model(TOY, False)
    values = _fill(shapes, np.random.default_rng(5))
    batch = {k: v for k, v in jax_make_batch(
        np.random.default_rng(0), batch_size=TOY["batch_size"],
        n_frames=TOY["T"], spatial_size=TOY["spatial"]).items()
        if k in ("images", "poke", "flow")}
    port = _port(values, values["flow"])
    SecondStageTrainer(port, LR).ddi({k: _t(v) for k, v in batch.items()})
    flow = to_numpy_tree(jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), port.flow_params.tree()))
    flow = _perturb(flow, np.random.default_rng(7), 0.03, 0.03)
    frozen = {k: FrozenBundle(_jnp(values[k]["params"]),
                              _jnp(values[k].get("batch_stats", {})))
              for k in ("fs", "cond", "poke")}

    def loss_fn(params, batch, rng):
        r1, r2 = jax.random.split(rng)
        z, logdet = jmodel.forward_density(params, frozen, batch, r1)
        return jflow_loss(z, logdet, rng=r2, spatial_mean=False)

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True, allow_int=True))
    return values, flow, batch, grad


@pytest.mark.parametrize("rule", ["use_adafactor", "use_adabelief"])
def test_rule_trajectory_matches_jax(start, rule):
    """30 steps at a constant lr: every NLL within ``TRAJECTORY_RTOL`` (5e-3)
    relative of the JAX package's, and the rule's state after them of the
    same kind (Adafactor: the factored rows and columns)."""
    values, flow, batch, grad = start
    params = {"flow": _jnp(flow)}
    tx = joptim.flow_adam(LR, params=params, **{rule: True})
    opt = tx.init(params)
    # the chain jitted on its own (eager optax takes ~1.5 s an update here)
    update = jax.jit(lambda g, opt, params: tx.update(
        joptim.zero_buffer_grads(g, params), opt, params))
    want = []
    for i in range(STEPS):
        (loss, log), g = grad(params, _jnp(batch), K(10 + i))
        upd, opt = update(g, opt, params)
        params = optax.apply_updates(params, upd)
        want.append(float(log["flow_loss"]))

    port = _port(values, flow)
    port.config["training"][rule] = True
    trainer = SecondStageTrainer(port, LR)
    trainer.start()
    tbatch = {k: _t(v) for k, v in batch.items()}
    got = [trainer.train_step(tbatch)["flow_loss"].item() for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL)
    assert trainer.tx.count == STEPS
    if rule == "use_adafactor":
        assert any(v is not None for v in trainer.tx.v_row)
        assert type(trainer.tx).__name__ == "Adafactor"
    else:
        assert type(trainer.tx).__name__ == "AdaBelief"
    assert not isinstance(trainer.tx, torch.optim.Optimizer)
