"""The port's FC second stage (``models/fc_baseline.py::SecondStageModelFC``)
against the JAX package's, fp32 on the CPU, at ``entry.FC_TINY`` with the
same weights (frozen FC first stage and encoders carried by
``convert.load_flax``, the flat cINN by ``convert.flow_params``) and the
JAX side's draws handed to the port as noise tensors:

* ``forward_density`` and ``ddi`` within 1e-4;
* ``forward_sample`` from the JAX model's own z within 2e-3;
* three NLL train steps (``train.SecondStageTrainer``'s step, AMSGrad at a
  constant lr) after DDI and a perturbation of the ActNorms, against the
  JAX experiment's step: the loss within 1e-4 relative (its NLL and
  logdet terms within 1e-4 of their magnitudes' sum: after a step AMSGrad
  moves a near-zero gradient's entries by a full lr of the sign its
  rounding gives, ``tests/test_torch_train.py``), with the Gaussian and
  the radial base.

The JAX side is one jitted program (``jax_outputs``): the density, DDI and
sampling, then per base DDI, the perturbation and the three steps (a
``lax.scan``), in place of ~1000 eagerly compiled primitives."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.flows import flow_loss as jflow_loss
from ipoke_tpu.models import fc_baseline as jfcb
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.models.second_stage import FrozenBundle
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import flow_params, load_flax
from ipoke_tpu_torch.core.optim import flow_adam
from ipoke_tpu_torch.models import fc_baseline as tfcb
from ipoke_tpu_torch.models import first_stage as tfs
from ipoke_tpu_torch.models.second_stage import (create_second_stage_state,
                                                 make_second_stage_train_step)

from test_torch_ops import _few_threads, _jnp, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill

K = jax.random.PRNGKey
FS = entry.FC_TINY["first_stage"]
# B = 4: DDI's ActNorm statistics (std with ddof 1) from 2 samples are
# degenerate, biases of O(10) from differences of O(0.1)
S, T, B = FS["data"]["spatial_size"][0], FS["data"]["max_frames"], 4
NF = entry.FC_TINY["encoders"]["nf_max"]
Z = FS["architecture"]["z_dim"]
LR = 1e-3


def _config(base):
    ss = copy.deepcopy(entry.FC_TINY["second_stage"])
    ss["training"]["base_distribution"] = base
    return ss


@pytest.fixture(scope="module")
def frozen_nets():
    """numpy weights over the JAX frozen nets (FC first stage, 3-channel
    conditioner, 2-channel poke embedder) and the flat cINN, a batch, and
    the port's frozen nets holding the same weights."""
    fs = jfs.build_first_stage(Config(FS))[0]
    cond = jfcb.FirstStageFCWrapper(spatial_size=S, nf_in=3, nf_max=NF)
    poke = jfcb.FirstStageFCWrapper(spatial_size=S, nf_in=2, nf_max=NF)
    jmodel = jfcb.SecondStageModelFC(Config(_config("gaussian")), fs, cond, poke)
    shapes = jax.eval_shape(lambda: {
        "fs": fs.init({"params": K(0)}, jnp.zeros((1, T + 1, S, S, 3)), rng=K(1),
                      train=False),
        "cond": cond.init({"params": K(2)}, jnp.zeros((1, S, S, 3)), train=False),
        "poke": poke.init({"params": K(3)}, jnp.zeros((1, S, S, 2)), train=False),
        "flow": jmodel.init(K(4))["flow"]})
    values = _fill(shapes, np.random.default_rng(7))
    b = jax_make_batch(np.random.default_rng(8), batch_size=B, n_frames=T, spatial_size=S)
    batch = {k: b[k] for k in ("images", "poke")}
    with torch.device("meta"):
        nets = (tfs.build_first_stage(FS)[0], tfcb.FirstStageFCWrapper(S, 3, NF),
                tfcb.FirstStageFCWrapper(S, 2, NF))
    nets = [n.to_empty(device="cpu") for n in nets]
    for net, key in zip(nets, ("fs", "cond", "poke")):
        load_flax(net, values[key]["params"], values[key]["batch_stats"])
        net.eval().requires_grad_(False)
    return (fs, cond, poke), values, batch, nets


def _models(frozen_nets, base, flow_values):
    (fs, cond, poke), values, batch, nets = frozen_nets
    jmodel = jfcb.SecondStageModelFC(Config(_config(base)), fs, cond, poke)
    frozen = {k: FrozenBundle(_jnp(values[k]["params"]), _jnp(values[k]["batch_stats"]))
              for k in ("fs", "cond", "poke")}
    port = tfcb.SecondStageModelFC(_config(base), *nets, flow_params(flow_values))
    return jmodel, frozen, port


def _noise(key):
    """The JAX first stage's posterior draw from ``key``."""
    return _t(jax.random.normal(key, (B, Z)))


BASES = ("gaussian", "radial")


@pytest.fixture(scope="module")
def jax_outputs(frozen_nets):
    """This file's one JAX program, jitted: ``forward_density`` (K10),
    ``ddi`` (K11) and ``forward_sample`` (K12) with the Gaussian base; then
    per base JAX's DDI (K20), every ActNorm of the result moved by N(0,
    0.05^2) (drawn here in numpy, seed 21) and three steps of the JAX
    experiment's step (keys K30..K32) from it at lr 1e-3, AMSGrad at a
    constant lr."""
    _, values, batch, _ = frozen_nets
    jmods = {base: _models(frozen_nets, base, values["flow"])[:2] for base in BASES}
    jb, p0 = _jnp(batch), {"flow": _jnp(values["flow"])}
    jmodel, frozen = jmods["gaussian"]
    shapes = jax.eval_shape(lambda: jmodel.ddi(p0, frozen, jb, K(20))["flow"])
    rng = np.random.default_rng(21)
    leaves, tdef = jax.tree_util.tree_flatten_with_path(shapes)
    noise = jax.tree_util.tree_unflatten(tdef, [
        (0.05 * rng.standard_normal(l.shape)).astype(np.float32)
        if str(path[-1]) in ("['log_scale']", "['bias']") and _actnorm(shapes, path)
        else np.zeros(l.shape, l.dtype) for path, l in leaves])
    keys = jnp.stack([K(30 + i) for i in range(3)])

    def steps(jmodel, frozen, start):
        tx = joptim.flow_adam(LR, params={"flow": start})

        def jstep(carry, rng):  # SecondStageFCExperiment's step
            params, opt = carry
            r1, r2 = jax.random.split(rng)

            def loss_fn(p):
                z, logdet = jmodel.forward_density(p, frozen, jb, r1)
                return jflow_loss(z, logdet, rng=r2, radial=jmodel.radial)

            (_, log), grads = jax.value_and_grad(loss_fn, has_aux=True,
                                                 allow_int=True)(params)
            grads = joptim.zero_buffer_grads(grads, params)
            upd, opt = tx.update(grads, opt, params)
            return (optax.apply_updates(params, upd), opt), log

        params = {"flow": start}
        return jax.lax.scan(jstep, (params, tx.init(params)), keys)[1]

    @jax.jit
    def run(p0, noise):
        out = {"density": jmodel.forward_density(p0, frozen, jb, K(10)),
               "ddi": jmodel.ddi(p0, frozen, jb, K(11))["flow"],
               "video": jmodel.forward_sample(p0, frozen, jb, K(12), length=T)}
        for base in BASES:
            jm, fr = jmods[base]
            start = jax.tree_util.tree_map(jnp.add, jm.ddi(p0, fr, jb, K(20))["flow"],
                                           noise)
            out[base] = {"start": start, "logs": steps(jm, fr, start)}
        return out

    return jax.tree_util.tree_map(np.asarray, run(p0, noise))


def _actnorm(tree, path):
    """Whether the leaf at ``path`` sits in an ActNorm node (one holding
    both ``log_scale`` and ``bias``)."""
    node = tree
    for key in path[:-1]:
        node = node[key.key if hasattr(key, "key") else key.idx]
    return isinstance(node, dict) and {"log_scale", "bias"} <= node.keys()


def test_forward_density_ddi_and_sample_match_jax(frozen_nets, jax_outputs):
    _, values, batch, _ = frozen_nets
    _, _, port = _models(frozen_nets, "gaussian", values["flow"])
    z, ld = jax_outputs["density"]
    tb = {k: _t(v) for k, v in batch.items()}
    got_z, got_ld = port.forward_density(tb, noise=_noise(K(10)))
    np.testing.assert_allclose(got_z.numpy(), z, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_ld.numpy(), ld, rtol=1e-4, atol=1e-4)
    got_new = port.ddi(tb, noise=_noise(K(11)))
    want = jax.tree_util.tree_leaves(jax_outputs["ddi"])
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got_new))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    z0 = _t(jax.random.normal(K(12), (B, Z)))  # sample_base's Gaussian draw
    got_video = port.forward_sample(tb, T, z=z0)
    assert got_video.shape == (B, T, S, S, 3) and torch.isfinite(got_video).all()
    np.testing.assert_allclose(got_video.numpy(), jax_outputs["video"], atol=2e-3)


@pytest.mark.parametrize("base", BASES)
def test_train_steps_match_jax(frozen_nets, jax_outputs, base):
    """JAX's DDI, the same ActNorm perturbation on both sides, then three
    steps of the JAX experiment's step and of the port's at lr 1e-3, the
    losses as the module docstring says (the reference NLL diagnostic draws
    its own sample on each side: finite)."""
    _, values, batch, _ = frozen_nets
    start = jax_outputs[base]["start"]
    _, _, port = _models(frozen_nets, base, start)
    tx_port = create_second_stage_state(port, lambda ps: flow_adam(ps, LR))
    step = make_second_stage_train_step(port, tx_port)
    tb = {k: _t(v) for k, v in batch.items()}
    density = port.forward_density
    gen = torch.Generator().manual_seed(22)
    for i in range(3):
        key = K(30 + i)
        want = {k: v[i] for k, v in jax_outputs[base]["logs"].items()}
        port.forward_density = lambda b, g=None: density(
            b, noise=_noise(jax.random.split(key)[0]))
        got = step(tb, gen)
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["flow_loss"].item(), float(want["flow_loss"]),
                                   rtol=1e-4, err_msg=f"{base} step {i}")
        scale = abs(float(want["nll_loss"])) + abs(float(want["nlogdet_loss"]))
        for k in ("nll_loss", "nlogdet_loss"):  # its two terms, at the sum's scale
            assert abs(got[k].item() - float(want[k])) <= 1e-4 * scale, (base, i, k)
        assert np.isfinite(got["reference_nll_loss"].item())
    assert port.radial == (base == "radial")
