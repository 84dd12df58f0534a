"""Three whole second-stage train steps of the port (ipoke_tpu_torch)
against the JAX package's ``make_second_stage_train_step``, in fp32 and in
bf16 with fp32 masters, from the same weights and batch (numpy seeds).  On
CPU tensors every kernel wrapper takes its plain version; in bf16 the NICE
couplings run K4's autograd Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models.first_stage import build_first_stage
from ipoke_tpu.models.second_stage import (
    FlowTrainState,
    FrozenBundle,
    SecondStageModel,
    make_second_stage_train_step,
)
from ipoke_tpu.nn.encoders import FirstStageWrapper
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import flow_params, load_flax, to_numpy_tree
from ipoke_tpu_torch.train import SecondStageTrainer

from test_torch_density import leaves
from test_torch_ops import _few_threads, _jnp, _np, _perturb, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill

K = jax.random.PRNGKey
# 4x4 latents: at 32 px the motion encoder's strides end at 4
TOY = dict(spatial=32, min_spatial=4, T=3, z_dim=16, enc_ch=(16, 16, 32, 32),
           dec_ch=(32, 32, 16, 16), nf_cond=8, num_steps=(1, 1), mid_factor=8,
           batch_size=2, deterministic=True)


# ---------------------------------------------------------------------------
# three train steps at a toy config
# ---------------------------------------------------------------------------

def _jax_model(cfg, mixed):
    """The JAX second stage at ``cfg`` (``__graft_entry__._make_models``
    with a deterministic first stage, so that motion = mu)."""
    s, m, T = cfg["spatial"], cfg["min_spatial"], cfg["T"]
    fs_cfg = Config({
        "data": {"spatial_size": (s, s), "max_frames": T},
        "architecture": {
            "z_dim": cfg["z_dim"], "ENC_M_channels": list(cfg["enc_ch"]),
            "dec_channels": list(cfg["dec_ch"]), "n_gru_layers": 2,
            "min_spatial_size": m, "norm": "group", "spectral_norm": True,
            "motion_bias": True, "deterministic": True},
        "training": {"full_sequence": True}, "d_t": {}, "d_s": {}})
    ss_cfg = Config({
        "data": {"spatial_size": (s, s), "max_frames": T},
        "architecture": entry.second_stage_config(cfg)["architecture"],
        "training": {"spatial_mean": False, "mixed_prec_master": mixed},
        "poke_embedder": {}})
    fs = build_first_stage(fs_cfg)[0]
    wrap = lambda nf_in: FirstStageWrapper(
        spatial_size=s, nf_in=nf_in, nf_max=cfg["nf_cond"], min_spatial_size=m,
        deterministic=True)
    cond, poke = wrap(3), wrap(2)
    model = SecondStageModel(ss_cfg, fs, cond, poke)
    shapes = jax.eval_shape(lambda: {
        "fs": fs.init({"params": K(0)}, jnp.zeros((1, T + 1, s, s, 3)),
                      rng=K(1), train=False),
        "cond": cond.init({"params": K(2)}, jnp.zeros((1, s, s, 3))),
        "poke": poke.init({"params": K(3)}, jnp.zeros((1, s, s, 2))),
        "flow": model.init(K(4))["flow"]})
    return model, shapes


@pytest.fixture(scope="module")
def toy_weights():
    """numpy weights over the JAX shapes, the flow through the JAX DDI on
    the batch, then perturbed (DDI leaves every coupling an identity)."""
    model, shapes = _jax_model(TOY, False)
    values = _fill(shapes, np.random.default_rng(5))
    frozen = {k: FrozenBundle(_jnp(values[k]["params"]),
                              _jnp(values[k].get("batch_stats", {})))
              for k in ("fs", "cond", "poke")}
    batch = {k: v for k, v in jax_make_batch(
        np.random.default_rng(0), batch_size=TOY["batch_size"],
        n_frames=TOY["T"], spatial_size=TOY["spatial"]).items()
        if k in ("images", "poke", "flow")}
    flow = jax.jit(model.ddi)({"flow": _jnp(values["flow"])}, frozen,
                              _jnp(batch), K(6))["flow"]
    flow = _perturb(to_numpy_tree(flow), np.random.default_rng(7), 0.03, 0.03)
    return values, frozen, flow, batch


LR = 1e-3


@pytest.mark.parametrize("mixed,rtol", [(False, 1e-4), (True, 2e-2)])
def test_train_steps_match_jax(toy_weights, mixed, rtol):
    """Three steps of ``make_second_stage_train_step`` with ``flow_adam`` at
    a constant lr: the losses, and the params after them.

    Losses: 1e-4 relative in fp32, 2e-2 in bf16 with fp32 masters
    (``master_weights``; both sides round activations at different places).
    Params: AMSGrad moves each by lr * m / (sqrt(vmax) + eps) whatever the
    gradient's size, so where a gradient entry is near zero its rounding
    noise sets the step's sign; the two sides stepping opposite ways part an
    entry by 2 lr a step: every entry within 6 lr (bf16: plus 2 ulps, 2^-7
    relative, as both sides hold bf16(master), JAX within 1 ulp).  Each
    leaf's change over the 3 steps within half of the JAX change's norm of
    it: a frozen update is off by 1, a sign-flipped one by 2; two correct
    trainers part by at most 0.37 (median 0.06) over the 222 leaves of this
    config, in fp32 and in bf16 alike.  In fp32 each leaf also within 1e-3
    of its norm; one wrong step per entry would be ~lr * sqrt(n) / ||p||,
    here ~1e-2."""
    values, frozen, flow, batch = toy_weights
    jmodel, _ = _jax_model(TOY, mixed)
    params = {"flow": _jnp(flow)}
    tx = joptim.flow_adam(LR, params=params)
    if mixed:
        tx = joptim.master_weights(tx)
        params = joptim.cast_floats(params, jnp.bfloat16)
        frozen = joptim.cast_floats(frozen, jnp.bfloat16)
    state = FlowTrainState(params=params, opt=tx.init(params),
                           step=jnp.zeros((), jnp.int32))
    step = jax.jit(make_second_stage_train_step(jmodel, tx))
    want = []
    for i in range(3):
        state, log = step(state, frozen, _jnp(batch), K(10 + i))
        want.append(float(log["flow_loss"]))

    port = entry.make_model(TOY, flow_params(flow))
    for sub, name in ((port.first_stage, "fs"), (port.conditioner, "cond"),
                      (port.poke_embedder, "poke")):
        load_flax(sub, values[name]["params"], values[name].get("batch_stats"))
    port.config["training"]["mixed_prec_master"] = mixed
    trainer = SecondStageTrainer(port, LR)
    trainer.start()
    p0 = [t.detach().clone() for t in leaves(port.flow_params.tree())]
    got = [trainer.train_step({k: _t(v) for k, v in batch.items()})["flow_loss"].item()
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=rtol)
    g_leaves = leaves(port.flow_params.tree())
    w_leaves = jax.tree_util.tree_leaves(state.params["flow"])
    assert len(g_leaves) == len(w_leaves) == len(p0)
    for p, g, w in zip(p0, g_leaves, w_leaves):
        if not g.is_floating_point():  # the shuffle permutations
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            continue
        assert g.dtype == (torch.bfloat16 if mixed else torch.float32)
        p, g, w = p.float().numpy(), g.detach().float().numpy(), _np(w)
        np.testing.assert_allclose(g, w, rtol=2 ** -7 if mixed else 0,
                                   atol=6 * LR)
        assert np.linalg.norm((g - p) - (w - p)) <= 0.5 * np.linalg.norm(w - p)
        if not mixed:
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)
