"""The second stage's conditioning and flow options in the port against
the JAX package's, on the CPU in fp32, from the same weights (numpy seeds,
carried by ``ipoke_tpu_torch.convert``) and batch:

* ``forward_density`` and ``forward_sample`` of two toy second stages:
  ``adapt`` (``poke_embedder.flow_ae``, a ``poke_and_image`` embedder at
  8x8 and a variational conditioner at 2x2 over a 4x4 first stage, so that
  both ``conv_adapt`` adapters run, and ``use1x1``) and ``stack`` (no
  conditioner, a ``MultiscaleStack`` with ``reshape: up`` of ``additive``
  steps over ``relu`` priors);
* 3 train steps of ``adapt`` against ``make_second_stage_train_step``;
* one image-AE step of a variational ``poke_and_image`` poke embedder, conv
  and FC, against ``make_image_ae_train_step``;
* a CLI run of a second stage without conditioner over ``flow_ae``.

Every JAX reference comes from one jitted program (the ``refs`` fixture),
which also returns the draws the port takes as tensors (the sampling z, the
AE's eps)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models import image_ae as jae
from ipoke_tpu.models.fc_baseline import FirstStageFCWrapper as JFCWrapper
from ipoke_tpu.models.first_stage import build_first_stage
from ipoke_tpu.models.second_stage import (
    FlowTrainState,
    FrozenBundle,
    SecondStageModel,
    make_second_stage_train_step,
)
from ipoke_tpu.nn import PatchDiscriminator2D as JaxPatchDisc
from ipoke_tpu.nn.encoders import FirstStageWrapper
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.cli.fc_experiments import _FCEncoderExperiment
from ipoke_tpu_torch.convert import (
    jax_second_stage_params,
    load_flax,
    load_image_ae,
    second_stage_params,
)
from ipoke_tpu_torch.core.optim import gan_adam
from ipoke_tpu_torch.models import image_ae as tae
from ipoke_tpu_torch.nn.vgg import VGG19Features
from ipoke_tpu_torch.train import SecondStageTrainer

from test_torch_cli import CONFIGS, DATA, SS, Env
from test_torch_density import leaves
from test_torch_first_stage import _assert_moments
from test_torch_flow_options import fill, lu_traceable
from test_torch_image_ae import _jax_state, _like, _moments, _vgg
from test_torch_image_ae import _batch as _ae_batch
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)

K = jax.random.PRNGKey
LR = 1e-3
TOY = dict(spatial=32, min_spatial=4, T=3, z_dim=16, enc_ch=(16, 16, 32, 32),
           dec_ch=(32, 32, 16, 16), nf_cond=8, num_steps=(1,), mid_factor=8,
           batch_size=2, deterministic=True, mixed=False)
VARIANTS = {
    "adapt": dict(TOY, flow_ae=True, poke_and_image=True, poke_min_spatial=8,
                  cond_deterministic=False, cond_min_spatial=2, use1x1=True),
    "stack": dict(TOY, conditioner=False, transform="additive",
                  prior_transform="relu", multistack=True, reshape="up",
                  levels=[[1], [1]], factors=[16, 4]),
}
# the image AE step: a variational poke_and_image poke embedder (no
# discriminator), conv and FC, at test_torch_image_ae.py's 16 px
S = 16
AE = {"data": {"spatial_size": (S, S)},
      "architecture": {"nf_in": 2, "nf_max": 16, "min_spatial_size": 4,
                       "deterministic": False, "poke_and_image": True},
      "training": {"perc_weight": 1.0}, "input_key": "poke", "target_key": "flow"}


def _jax_model(cfg):
    """The JAX second stage of a variant, and its init shapes."""
    s, m, T = cfg["spatial"], cfg["min_spatial"], cfg["T"]
    fs_cfg = Config({
        "data": {"spatial_size": (s, s), "max_frames": T},
        "architecture": {
            "z_dim": cfg["z_dim"], "ENC_M_channels": list(cfg["enc_ch"]),
            "dec_channels": list(cfg["dec_ch"]), "n_gru_layers": 2,
            "min_spatial_size": m, "norm": "group", "spectral_norm": True,
            "motion_bias": True, "deterministic": True},
        "training": {"full_sequence": True}, "d_t": {}, "d_s": {}})
    ss = entry.second_stage_config(cfg)
    ss_cfg = Config({"data": {"spatial_size": (s, s), "max_frames": T}, **ss})
    fs = build_first_stage(fs_cfg)[0]
    cond = FirstStageWrapper(
        spatial_size=s, nf_in=3, nf_max=cfg["nf_cond"],
        min_spatial_size=cfg.get("cond_min_spatial", m),
        deterministic=cfg.get("cond_deterministic", True)) \
        if cfg.get("conditioner", True) else None
    poke = FirstStageWrapper(spatial_size=s, nf_in=2, nf_max=cfg["nf_cond"],
                             min_spatial_size=cfg.get("poke_min_spatial", m),
                             poke_and_image=cfg.get("poke_and_image", False))
    model = SecondStageModel(ss_cfg, fs, cond, poke)
    init = {
        "fs": lambda: fs.init({"params": K(0)}, jnp.zeros((1, T + 1, s, s, 3)),
                              rng=K(1), train=False),
        "poke": lambda: poke.init({"params": K(3)}, jnp.zeros(
            (1, s, s, 5 if cfg.get("poke_and_image") else 2))),
        "params": lambda: model.init(K(4))}
    if cond is not None:
        init["cond"] = lambda: cond.init({"params": K(2)}, jnp.zeros((1, s, s, 3)))
    with lu_traceable():
        return model, jax.eval_shape(lambda: {k: f() for k, f in init.items()})


def _frozen(values):
    return {k: FrozenBundle(_jnp(values[k]["params"]),
                            _jnp(values[k].get("batch_stats", {})))
            for k in ("fs", "cond", "poke") if k in values}


def _ae_models():
    """(conv, FC) JAX poke embedders of ``AE``, their discriminator and VGG."""
    cfg = Config(copy.deepcopy(AE))
    fc = JFCWrapper(spatial_size=S, nf_in=2, nf_max=16, deterministic=False,
                    poke_and_image=True)
    return cfg, (jae.build_image_ae(cfg), fc), JaxPatchDisc(ndf=8, n_layers=2), _vgg()


@pytest.fixture(scope="module")
def refs():
    """numpy weights and batches, and every JAX reference: per variant the
    density (z, logdet), the sampled video and its z; 3 train steps of
    ``adapt`` (losses, params); one step of each image AE (metrics, state)
    and its eps.  One jitted program."""
    rng = np.random.default_rng(5)
    models, values = {}, {}
    for name, cfg in VARIANTS.items():
        models[name], shapes = _jax_model(cfg)
        values[name] = fill(shapes, rng)
    batch = {k: v for k, v in jax_make_batch(
        np.random.default_rng(0), batch_size=TOY["batch_size"],
        n_frames=TOY["T"], spatial_size=TOY["spatial"]).items()
        if k in ("images", "poke", "flow")}
    ae_cfg, ae_models, disc, vgg = _ae_models()
    tx = joptim.gan_adam(LR)
    ae_states = [_jax_state(ae_cfg, m, disc, tx, False) for m in ae_models]
    ae_batch = _ae_batch()
    flow_tx = joptim.flow_adam(LR, params=_jnp(values["adapt"]["params"]))

    def program(values, batch, ae_states, ae_batch):
        out = {}
        for name, model in models.items():
            v, frozen = values[name], _frozen(values[name])
            z, ld = model.forward_density(v["params"], frozen, batch, K(1))
            s = model.min_spatial_size
            shape = model.flow.output_shape((s, s, model.flow_in_channels))
            out[name] = {"z": z, "ld": ld,
                         "video": model.forward_sample(v["params"], frozen, batch,
                                                       K(2), TOY["T"]),
                         "z_sample": jax.random.normal(
                             K(2), (batch["images"].shape[0], *shape))}
        step = make_second_stage_train_step(models["adapt"], flow_tx)
        params = values["adapt"]["params"]
        frozen = _frozen(values["adapt"])

        def body(state, key):
            state, log = step(state, frozen, batch, key)
            return state, log["flow_loss"]

        state = FlowTrainState(params=params, opt=flow_tx.init(params),
                               step=jnp.zeros((), jnp.int32))
        state, losses = jax.lax.scan(body, state, jnp.stack([K(10), K(11), K(12)]))
        out["train"] = {"losses": losses, "params": state.params}
        for i, (m, st) in enumerate(zip(ae_models, ae_states)):
            jstep = jae.make_image_ae_train_step(ae_cfg, m, disc, vgg, tx, tx,
                                                 use_disc=False)
            new, metrics = jstep(st, ae_batch, K(20), 0.0)
            x_in = jnp.concatenate([ae_batch["poke"], ae_batch["images"][:, 0]], -1)
            mean = m.apply({"params": st.params["ae"], "batch_stats": st.stats}, x_in,
                           method=type(m).encode)[1]
            out[f"ae{i}"] = {"state": new, "metrics": metrics,
                             "eps": jax.random.normal(jax.random.split(K(20))[0],
                                                      mean.shape)}
        return out

    want = jax.jit(program)(_jnp(values), _jnp(batch), ae_states, _jnp(ae_batch))
    want = jax.tree_util.tree_map(np.asarray, want)
    return values, batch, ae_states, ae_batch, want


def _port(values, cfg):
    """The port's model of a variant from the numpy weights."""
    model = entry.make_model(cfg, second_stage_params(values["params"]))
    for sub, name in ((model.first_stage, "fs"), (model.conditioner, "cond"),
                      (model.poke_embedder, "poke")):
        if sub is not None:
            load_flax(sub, values[name]["params"], values[name].get("batch_stats"))
    return model.eval()


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# density and sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_density_matches_jax(refs, name):
    """z and logdet at 2e-4; the tree carries across both ways."""
    values, batch, _, _, want = refs
    model = _port(values[name], VARIANTS[name])
    z, ld = model.forward_density({k: _t(v) for k, v in batch.items()})
    close(z, want[name]["z"], 2e-4)
    close(ld, want[name]["ld"], 2e-4)
    back, ref = leaves(jax_second_stage_params(model)), leaves(values[name]["params"])
    assert len(back) == len(ref) > 0
    for a, b in zip(back, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_sample_matches_jax(refs, name):
    """The video from JAX's z at 2e-3: the flow's inverse at z's shape (the
    reshaped one of a stack), then the decode."""
    values, batch, _, _, want = refs
    model = _port(values[name], VARIANTS[name])
    z = _t(want[name]["z_sample"])
    assert tuple(z.shape[1:]) == model.z_shape()
    video = model.forward_sample({k: _t(v) for k, v in batch.items()}, TOY["T"], z=z)
    close(video, want[name]["video"], 2e-3)


def test_variant_structure(refs):
    """What each option changes: the embedded key, h's width, the adapters
    in the trainable tree, the stack's base shape."""
    values = refs[0]
    adapt, stack = (_port(values[n], VARIANTS[n]) for n in ("adapt", "stack"))
    assert adapt.poke_key == "flow" and stack.poke_key == "poke"
    assert adapt.adapters == {"adapt_poke": (8, 8), "adapt_cond": (2, 8)}
    assert {"adapt_poke", "adapt_cond", "flow"} == set(adapt.flow_params.tree())
    assert stack.conditioner is None and stack.flow.h_channels == TOY["nf_cond"]
    h = stack.embed_conditioning({k: _t(v) for k, v in refs[1].items()})
    assert h.shape == (TOY["batch_size"], 4, 4, TOY["nf_cond"])
    assert stack.z_shape() == (8, 8, 4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_adapt_train_steps_match_jax(refs):
    """3 steps of ``adapt`` (conv_adapt both ways, use1x1, flow_ae, the
    variational poke_and_image embedders) at a constant lr in fp32: losses
    within 1e-4 relative; every leaf within 6 lr of JAX's (AMSGrad moves
    each entry by ~lr), the adapters moved on both sides."""
    values, batch, _, _, want = refs
    model = _port(values["adapt"], VARIANTS["adapt"])
    trainer = SecondStageTrainer(model, LR)
    trainer.start()
    p0 = {k: [t.detach().clone() for t in leaves(v)]
          for k, v in model.flow_params.tree().items()}
    got = [trainer.train_step({k: _t(v) for k, v in batch.items()})["flow_loss"].item()
           for _ in range(3)]
    np.testing.assert_allclose(got, want["train"]["losses"], rtol=1e-4)
    new = model.flow_params.tree()
    for key in ("adapt_poke", "adapt_cond", "flow"):
        g, w = leaves(new[key]), leaves(want["train"]["params"][key])
        assert len(g) == len(w) == len(p0[key])
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.detach().numpy(), b, atol=6 * LR)
        if key != "flow":
            assert all(not torch.equal(a, b) for a, b in zip(g, p0[key])), key
            assert all(not np.array_equal(a.numpy(), b) for a, b in zip(p0[key], w))


@pytest.mark.parametrize("fc", [False, True], ids=["conv", "fc"])
def test_variational_poke_and_image_ae_step_matches_jax(refs, fc):
    """One step of a variational poke_and_image poke embedder, conv and FC
    (the FC encoder experiment's build), the eps JAX draws given as
    ``noise``: metrics within 1e-4 relative, params within 2 lr with at most
    1% of the entries past lr / 10, Adam's first moments by the first-stage
    rule."""
    _, _, ae_states, ae_batch, want = refs
    state, ref = ae_states[int(fc)], want[f"ae{int(fc)}"]
    cfg = copy.deepcopy(AE)
    with torch.device("meta"):
        port = _FCEncoderExperiment.build_ae(None, cfg) if fc else tae.build_image_ae(cfg)
    port = entry.materialize(port, "cpu", torch.Generator().manual_seed(0))
    load_image_ae(port, jax.tree_util.tree_map(np.asarray, state.params),
                  jax.tree_util.tree_map(np.asarray, state.stats))
    assert port.ae.poke_and_image and not port.ae.deterministic
    pvgg = VGG19Features()
    load_flax(pvgg, jax.tree_util.tree_map(np.asarray, _vgg()["params"]))
    tx, _ = tae.create_image_ae_state(port, None, lambda ps: gan_adam(ps, LR),
                                      use_disc=False)
    step = tae.make_image_ae_train_step(cfg, port, None, pvgg, tx, None, False)
    batch = {k: torch.as_tensor(v) for k, v in ae_batch.items()}
    p0 = [q.detach().clone() for q in tx.params]
    got = step(batch, 0.0, noise=torch.tensor(ref["eps"]))
    for k, w in ref["metrics"].items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    params, stats = ref["state"].params, ref["state"].stats
    want_p = _like(port.ae, params["ae"], stats) + [torch.tensor(params["logvar"])]
    off = 0
    for g, w in zip(tx.params, want_p):
        torch.testing.assert_close(g.detach(), w, rtol=0, atol=2 * LR)
        off += int(((g.detach() - w).abs() > 0.1 * LR).sum())
    assert off <= 0.01 * sum(p.numel() for p in p0)
    mu = ref["state"].opt[1].mu
    _assert_moments(_moments(tx), _like(port.ae, mu["ae"], stats)
                    + [torch.tensor(mu["logvar"])])
    heads = [n for n, _ in port.ae.named_parameters()
             if ("NormConv2d_1" in n or "Dense_1" in n)]
    assert heads  # the log-std head trained with the rest


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_second_stage_without_conditioner_over_flow_ae(tmp_path):
    """``python -m ipoke_tpu_torch.main`` trains a second stage with
    ``conditioner.use: false`` over a ``flow_ae`` poke embedder at 8x8 (a
    strided adapter to the first stage's 4x4), its frozen nets drawn from
    the seed: one epoch of 2 steps, validation finite; ``--resume`` goes
    on from its step."""
    env = Env(tmp_path)
    poke = {"data": dict(DATA), "architecture": {"nf_in": 2, "nf_max": 16,
                                                 "min_spatial_size": 8}}
    cfg = dict(copy.deepcopy(SS), general={"experiment": "second_stage", "seed": 1},
               data=dict(DATA),
               first_stage={"config": dict(CONFIGS["first_stage"], data=dict(DATA))},
               conditioner={"use": False},
               poke_embedder={"flow_ae": True, "config": poke})
    path = str(tmp_path / "ss.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    e = env.run(path)
    assert e.model.conditioner is None and e.model.poke_key == "flow"
    assert set(e.model.flow_params.tree()) == {"flow", "adapt_poke"}
    assert e.step == 2 and e.ddi_runs == 1
    e2 = env.run(path, "--resume")
    assert e2.step == 4 and e2.ddi_runs == 0
