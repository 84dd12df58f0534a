"""``architecture.augmented_input`` (``augment_channels`` 4) at the toy
config of ``tests/test_torch_train.py``: the port's density forward, DDI,
sampling and one step's loss and gradients against the JAX package's, from
the same weights (carried both ways by ``convert.second_stage_params`` /
``jax_second_stage_params``) and JAX's own ``jax.random.normal`` draws fed
to the port.  One jitted JAX program returns all four."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.flows import flow_loss as jflow_loss
from ipoke_tpu.models.first_stage import build_first_stage
from ipoke_tpu.models.second_stage import FrozenBundle, SecondStageModel
from ipoke_tpu.nn.encoders import FirstStageWrapper
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import (jax_second_stage_params, load_flax,
                                     second_stage_params)
from ipoke_tpu_torch.flows import flow_loss

from test_torch_density import leaves
from test_torch_ops import _few_threads, _jnp, _np, _perturb, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill
from test_torch_train import TOY

K = jax.random.PRNGKey
AUG = dict(TOY, augment_channels=4)
TOL = 2e-4


def _jax_model(cfg):
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
        "training": {"spatial_mean": False}, "poke_embedder": {}})
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
        "params": model.init(K(4))})
    return model, shapes


@pytest.fixture(scope="module")
def both():
    """The JAX model's outputs from one jitted program, and the port built
    on the same weights: the flow perturbed, the augmentation's scale and
    shift away from 1 and 0."""
    jmodel, shapes = _jax_model(AUG)
    rng = np.random.default_rng(5)
    values = _fill(shapes, rng)
    params = values["params"]
    params["flow"] = _perturb(params["flow"], rng, 0.03, 0.03)
    params["scale_augment"] = (1.0 + 0.2 * rng.standard_normal(4)).astype(np.float32)
    params["shift_augment"] = (0.2 * rng.standard_normal(4)).astype(np.float32)
    frozen = {k: FrozenBundle(_jnp(values[k]["params"]),
                              _jnp(values[k].get("batch_stats", {})))
              for k in ("fs", "cond", "poke")}
    batch = {k: v for k, v in jax_make_batch(
        np.random.default_rng(0), batch_size=AUG["batch_size"],
        n_frames=AUG["T"], spatial_size=AUG["spatial"]).items()
        if k in ("images", "poke", "flow")}

    def run(params, batch, rng):
        z, logdet = jmodel.forward_density(params, frozen, batch, rng)
        new = jmodel.ddi(params, frozen, batch, rng)
        video = jmodel.forward_sample(params, frozen, batch, rng, AUG["T"])

        def loss_fn(p):  # make_second_stage_train_step's loss
            r1, r2 = jax.random.split(rng)
            zz, ld = jmodel.forward_density(p, frozen, batch, r1)
            return jflow_loss(zz, ld, rng=r2, spatial_mean=False)

        (_, log), grads = jax.value_and_grad(loss_fn, has_aux=True,
                                             allow_int=True)(params)
        return z, logdet, new, video, log["flow_loss"], grads

    rng = K(9)
    out = jax.jit(run)(_jnp(params), _jnp(batch), rng)
    B, s, C = AUG["batch_size"], AUG["min_spatial"], 4
    draws = {  # the JAX functions' own draws, recomputed from their keys
        "aug": jax.random.normal(jax.random.split(rng)[1], (B, s, s, C)),
        "z": jax.random.normal(rng, (B, s, s, AUG["z_dim"] + C)),
        "aug_step": jax.random.normal(jax.random.split(jax.random.split(rng)[0])[1],
                                      (B, s, s, C))}
    port = entry.make_model(AUG, second_stage_params(params))
    for sub, name in ((port.first_stage, "fs"), (port.conditioner, "cond"),
                      (port.poke_embedder, "poke")):
        load_flax(sub, values[name]["params"], values[name].get("batch_stats"))
    port.config["training"]["mixed_prec_master"] = False
    return out, draws, port, params, {k: _t(v) for k, v in batch.items()}


def test_augmented_tree_round_trips(both):
    """The port's tree is JAX's: flow_in = z_dim + 4, ``scale_augment`` and
    ``shift_augment`` at the top, and back to JAX's params unchanged."""
    _, _, port, params, _ = both
    assert port.flow_in_channels == AUG["z_dim"] + 4
    tree = port.flow_params.tree()
    assert set(tree) == {"flow", "scale_augment", "shift_augment"}
    back = jax_second_stage_params(port)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    init = port.init_params(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(init["scale_augment"], torch.ones(4))
    assert torch.equal(init["shift_augment"], torch.zeros(4))


def test_augmented_density_ddi_and_sample_match_jax(both):
    """forward_density and ddi with JAX's augmentation draw, forward_sample
    from JAX's z (the extra channels dropped after the inverse): within
    2e-4."""
    (z, logdet, new, video, _, _), draws, port, _, batch = both
    aug = _t(draws["aug"])
    got_z, got_ld = port.forward_density(batch, aug_noise=aug)
    np.testing.assert_allclose(got_z.detach().numpy(), _np(z), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_ld.detach().numpy(), _np(logdet), rtol=TOL, atol=TOL)
    got_new = port.ddi(batch, aug_noise=aug)
    assert set(got_new) == {"flow", "scale_augment", "shift_augment"}
    for a, b in zip(leaves(got_new), jax.tree_util.tree_leaves(new)):
        np.testing.assert_allclose(a.float().numpy(), _np(b), rtol=TOL, atol=TOL)
    got_video = port.forward_sample(batch, AUG["T"], z=_t(draws["z"]))
    np.testing.assert_allclose(got_video.numpy(), _np(video), rtol=TOL, atol=TOL)


def test_augmented_step_matches_jax(both):
    """One step's NLL and gradients (the step's own split of its key for the
    draw): the loss within 2e-4 relative, every leaf's gradient within 2e-4
    of its norm (``scale_augment`` and ``shift_augment`` included)."""
    (*_, loss, grads), draws, port, _, batch = both
    params = port.flow_params.trainable()
    z, logdet = port.forward_density(batch, aug_noise=_t(draws["aug_step"]))
    got, _ = flow_loss(z, logdet)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    tree = port.flow_params.tree()
    assert tree["scale_augment"].grad is not None
    flat = [t for t in leaves(tree) if t.is_floating_point()]
    want = [w for w in jax.tree_util.tree_leaves(grads) if w.dtype == jnp.float32]
    assert len(flat) == len(want) == len(params)
    for t, w in zip(flat, want):
        w = _np(w)
        assert np.linalg.norm(t.grad.numpy() - w) <= TOL * np.linalg.norm(w) + 1e-7
