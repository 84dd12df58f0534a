"""The port's FC third stage (``models/third_stage.py::ThirdStageFC``,
``train.ThirdStageFCTrainer``, the third-stage ``--test`` modes) against
the JAX package's, fp32 on the CPU, at ``entry.FC_THIRD_TINY`` (a flow
encoder of z_dim 6 below the residual's 8: the INN's input is padded with
N(0, 1) entries) with the same weights: the frozen FC stack and BigAE
carried by ``convert.load_flax``, the second stage's flat cINN and the
third stage's ``{"inn": ...}`` tree by ``convert.flow_params``; the JAX
side's draws handed to the port as noise tensors.

* ``forward_density`` and ``forward_sample_flow``, unconditioned and
  conditioned on the poke embedding, within 1e-5;
* two steps of ``ThirdStageFCTrainer`` against the JAX package's
  ``make_third_stage_fc_train_step`` (its target the JAX second stage's
  own ``forward_density``) by ``tests/test_torch_first_stage.py``'s rule:
  metrics 1e-4 relative, Adam's first moments by leaf norm, params within
  2 lr a step;
* ``cli.testing._third_stage_fns``' closures (extract, sample with an
  explicit z, recon) against the JAX package's on the conditioned model,
  within 1e-5, and ``sample_video``'s frames against the JAX experiment's
  within 2e-3;
* the realism and accuracy modes of both packages on the same flows (stub
  runs; the same VGG19 named by ``IPOKE_VGG_WEIGHTS``): the FID within
  1e-5 relative, the error categories and every artifact equal;
* the three plots of ``utils/plots.py`` (the nearest-neighbour CSV as
  pandas writes it in the JAX package).

The JAX sides of the models are one jitted program (``jax_ref``); the
modes' run eagerly (``jax.disable_jit``)."""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.cli import fc_experiments as jfcx
from ipoke_tpu.cli import testing as jtesting
from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models import fc_baseline as jfcb
from ipoke_tpu.models import fc_stack as jfcs
from ipoke_tpu.models import first_stage as jfs
from ipoke_tpu.models import third_stage as jts
from ipoke_tpu.models.second_stage import FrozenBundle
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.cli import testing as ttesting
from ipoke_tpu_torch.convert import flow_params, load_flax
from ipoke_tpu_torch.models import fc_baseline as tfcb
from ipoke_tpu_torch.models import fc_stack as tfcs
from ipoke_tpu_torch.models import first_stage as tfs
from ipoke_tpu_torch.models import third_stage as tts
from ipoke_tpu_torch.train import ThirdStageFCTrainer

from test_torch_density import leaves
from test_torch_first_stage import _assert_metrics, _assert_moments, _step
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill
from test_torch_testing import _Data, weights_env  # noqa: F401  (the VGG npz fixture)

K = jax.random.PRNGKey
CFG = entry.FC_THIRD_TINY
FS, FE, TS = CFG["first_stage"], CFG["flow_encoder"], CFG["third_stage"]
S, T, B = FS["data"]["spatial_size"][0], FS["data"]["max_frames"], 4
NF = CFG["encoders"]["nf_max"]
Z = FS["architecture"]["z_dim"]  # the residual's dims, the INN's
ZF = FE["architecture"]["z_dim"]  # the flow latent's
LR, STEP_KEYS = 1e-3, (K(40), K(41))
TOL = 1e-5


def _ts_config():
    return dict(TS, architecture=dict(TS["architecture"], flow_in_channels=Z))


@pytest.fixture(scope="module")
def tiny():
    """The JAX models (second stage, BigAE, the third stage unconditioned
    and conditioned), numpy weights over their shapes, the JAX frozen
    bundles, a batch, and the port's models holding the same weights."""
    fs = jfs.build_first_stage(Config(FS))[0]
    cond = jfcb.FirstStageFCWrapper(spatial_size=S, nf_in=3, nf_max=NF)
    poke = jfcb.FirstStageFCWrapper(spatial_size=S, nf_in=2, nf_max=NF)
    jss = jfcb.SecondStageModelFC(Config(CFG["second_stage"]), fs, cond, poke)
    bigae = jfcs.build_big_ae(Config(FE))
    jmodels = {c: jts.ThirdStageFC(Config(_ts_config()), bigae, None, NF if c else 0)
               for c in (False, True)}
    shapes = jax.eval_shape(lambda: {
        "fs": fs.init({"params": K(0)}, jnp.zeros((1, T + 1, S, S, 3)), rng=K(1),
                      train=False),
        "cond": cond.init({"params": K(2)}, jnp.zeros((1, S, S, 3)), train=False),
        "poke": poke.init({"params": K(3)}, jnp.zeros((1, S, S, 2)), train=False),
        "flow": jss.init(K(4))["flow"],
        "fe": bigae.init({"params": K(5)}, jnp.zeros((1, S, S, 2)), rng=K(6)),
        "inn": jmodels[False].init(K(7)), "inn_c": jmodels[True].init(K(8))})
    values = _fill(shapes, np.random.default_rng(9))
    frozen = {k: FrozenBundle(_jnp(values[k]["params"]), _jnp(values[k]["batch_stats"]))
              for k in ("fs", "cond", "poke")}
    frozen["flow_enc"] = FrozenBundle(_jnp(values["fe"]["params"]), {})
    ss_params = {"flow": _jnp(values["flow"])}
    density = lambda fr, b, r: jss.forward_density(ss_params, fr, b, r)[0]
    for m in jmodels.values():
        m.second_stage_density = density
    cond_fn = lambda fr, b: jss.embed_conditioning(fr, b)[:, -NF:]
    b = jax_make_batch(np.random.default_rng(10), batch_size=B, n_frames=T, spatial_size=S)
    batch = {k: b[k] for k in ("images", "poke", "flow")}

    with torch.device("meta"):
        nets = (tfs.build_first_stage(FS)[0], tfcb.FirstStageFCWrapper(S, 3, NF),
                tfcb.FirstStageFCWrapper(S, 2, NF), tfcs.build_big_ae(FE))
    nets = [n.to_empty(device="cpu") for n in nets]
    for net, key in zip(nets, ("fs", "cond", "poke", "fe")):
        load_flax(net, values[key]["params"], values[key].get("batch_stats"))
        net.eval().requires_grad_(False)
    port_ss = tfcb.SecondStageModelFC(CFG["second_stage"], *nets[:3],
                                      flow_params(values["flow"]))
    inn = {c: values["inn_c" if c else "inn"] for c in (False, True)}
    ports = {c: tts.ThirdStageFC(_ts_config(), nets[3], port_ss, NF if c else 0,
                                 flow_params(inn[c])) for c in (False, True)}
    jax_side = SimpleNamespace(models=jmodels, ss=jss, ss_params=ss_params, frozen=frozen,
                               cond_fn=cond_fn, params={c: _jnp(inn[c]) for c in ports})
    return jax_side, ports, batch


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _variant(conditional):
    return "conditional" if conditional else "unconditional"


def _flow_input_draws(key):
    """``ThirdStageFC.make_flow_input``'s draws from ``key``: the
    posterior's eps and the padding entries."""
    r1, r2 = jax.random.split(key)
    return jax.random.normal(r1, (B, ZF)), jax.random.normal(r2, (B, Z - ZF))


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """Every JAX side of this file but the modes', as one jitted program:

    * per variant, ``forward_density`` (key 10) and ``forward_sample_flow``
      (key 11, its z drawn from it);
    * on the conditioned model, the modes' closures: extract (key 20, the
      second stage's motion draw; with the residual it seeds), sample (key
      21) and recon;
    * the JAX experiment's ``sample_video`` (key 22) of the unconditioned
      model;
    * two steps of ``make_third_stage_fc_train_step`` as a ``lax.scan``
      (its target the JAX second stage's ``forward_density``), each with its
      metrics, params, first moments and draws: the key splits into r1 (the
      flow input), r2 (the second stage's motion draw) and r3 (the
      ``reference_nll_loss`` sample).  ``flow_adam`` at a constant lr
      (AMSGrad, decay 1e-5)."""
    j, _, batch = tiny

    @jax.jit
    def run(frozen, batch, params):
        out = {}
        for c in (False, True):
            h = j.cond_fn(frozen, batch) if c else None
            out[_variant(c)] = (*j.models[c].forward_density(params[c], frozen, batch, K(10), h),
                      *j.models[c].forward_sample_flow(params[c], frozen, batch, K(11), h))
        jexp = SimpleNamespace(model=j.models[True], ss_model=j.ss, ss_params=j.ss_params,
                               cond_fn=j.cond_fn, frozen=frozen,
                               state=SimpleNamespace(params=params[True]))
        extract, sample, recon = jtesting._third_stage_fns(jexp)
        out["fns"] = (extract(params[True], frozen, batch, K(20)),
                      sample(params[True], frozen, batch, K(21)), recon(frozen, batch))
        out["residual"] = j.ss.forward_density(j.ss_params, frozen, batch, K(20))[0]
        jexp.model, jexp.cond_fn = j.models[False], None
        jexp.state.params = params[False]
        out["video"] = jfcx.ThirdStageFCExperiment.sample_video(jexp, batch, K(22), T)

        tx = joptim.flow_adam(LR, params=params[False])
        jstep = jts.make_third_stage_fc_train_step(j.models[False], tx)

        def step(state, key):
            r1, r2, r3 = jax.random.split(key, 3)
            state, log = jstep(state, frozen, batch, key)
            draws = (jax.random.normal(r2, (B, Z)), *_flow_input_draws(r1),
                     jax.random.normal(r3, (B, Z)))
            mu = state.opt.inner_states["train"].inner_state[1].mu
            return state, (log, state.params, mu, draws)

        state = jts.create_third_stage_state(K(0), j.models[False], tx)
        state = state.replace(params=params[False], opt=tx.init(params[False]))
        out["steps"] = jax.lax.scan(step, state, jnp.stack(STEP_KEYS))[1]
        return out

    return jax.tree_util.tree_map(np.asarray, run(j.frozen, _jnp(batch), j.params))


@pytest.mark.parametrize("conditional", [False, True])
def test_forward_density_and_sample_flow_match_jax(tiny, jax_ref, conditional):
    _, ports, batch = tiny
    port, tb = ports[conditional], _tb(batch)
    h = port.condition(tb)
    assert (h is None) == (not conditional)
    got = (*port.forward_density(tb, noise=tuple(map(_t, _flow_input_draws(K(10)))), h=h),
           *port.forward_sample_flow(tb, h=h, z=_t(jax.random.normal(K(11), (B, Z)))))
    assert [tuple(g.shape) for g in got] == [(B, Z), (B,), (B, S, S, 2), (B, Z - ZF)]
    for name, a, w in zip(("out", "logdet", "flow", "rest"), got,
                          jax_ref[_variant(conditional)]):
        np.testing.assert_allclose(a.detach().numpy(), w, rtol=TOL, atol=TOL, err_msg=name)


def test_train_steps_match_jax(tiny, jax_ref):
    """Two steps of the trainer (constant lr) from the same weights, with
    the JAX step's draws: every metric, the first moments of every INN leaf
    and its params; the frozen nets stay as they were."""
    _, ports, batch = tiny
    logs, params, mus, draws = jax_ref["steps"]
    port = copy.deepcopy(ports[False])
    frozen0 = [t.clone() for t in port.second_stage.parameters()] + \
        [t.clone() for t in port.flow_encoder.parameters()]
    trainer = ThirdStageFCTrainer(port, LR)
    for i in range(len(STEP_KEYS)):
        noise = tuple(_t(d[i]) for d in draws)
        _assert_metrics(trainer.train_step(_tb(batch), 0, noise=noise), logs, i)
        tree = port.inn_params.tree()
        tx = trainer.state.tx
        moment = {id(p): tx.adam.state[p]["exp_avg"].numpy() for p in tx.params}
        _assert_moments([moment[id(t)] for t in leaves(tree) if id(t) in moment],
                        jax.tree_util.tree_leaves(_step(mus, i)))
        for g, w in zip(leaves(tree), jax.tree_util.tree_leaves(_step(params, i))):
            np.testing.assert_allclose(g.detach().numpy(), w, atol=2 * LR * (i + 1), rtol=0)
    assert trainer.state.step == 2
    assert all(torch.equal(a, b) for a, b in zip(
        frozen0, [*port.second_stage.parameters(), *port.flow_encoder.parameters()]))


def test_third_stage_fns_and_sample_video_match_jax(tiny, jax_ref, monkeypatch):
    """The modes' closures on the conditioned model within 1e-5: sample
    from the JAX z, recon, and extract seeded with the JAX second stage's
    residual.  That residual and the port's from the same motion draw agree
    within 1e-4 (the FC second stage's own parity: its 3D convs sum in
    other orders, ~3e-5 of the residual's size), and the INN inverse and
    decode carry such a difference on at its size, so the seed is handed
    over.  ``sample_video`` (measured flow -> INN -> residual -> video) of
    the unconditioned model against the JAX experiment's with its draws,
    within 2e-3."""
    _, ports, batch = tiny
    tb, port = _tb(batch), ports[True]
    motion = _t(jax.random.normal(K(20), (B, Z)))
    residual = port.second_stage_density(tb, None, motion).numpy()
    assert np.abs(residual - jax_ref["residual"]).max() <= 1e-4 * np.abs(residual).max()
    monkeypatch.setattr(port, "second_stage_density",
                        lambda batch, generator, m: _t(jax_ref["residual"]))
    extract, sample, recon = ttesting._third_stage_fns(SimpleNamespace(model=port,
                                                                       generator=None))
    got = (extract(tb, motion=motion), sample(tb, z=_t(jax.random.normal(K(21), (B, Z)))),
           recon(tb))
    for name, a, w in zip(("extract", "sample", "recon"), got, jax_ref["fns"]):
        assert a.shape == (B, S, S, 2)
        np.testing.assert_allclose(a.numpy(), w, rtol=TOL, atol=TOL, err_msg=name)
    r1, _ = jax.random.split(K(22))
    video = ports[False].forward_video_from_flow(
        tb, T, noise=tuple(map(_t, _flow_input_draws(r1))))
    assert video.shape == (B, T, S, S, 3) and torch.isfinite(video).all()
    np.testing.assert_allclose(video.numpy(), jax_ref["video"], atol=2e-3)


# ---------------------------------------------------------------------------
# the modes' reductions on the same flows
# ---------------------------------------------------------------------------

MODE_CFG = {"general": {"seed": 3, "experiment": "third_stage_fc"},
            "data": {"max_frames": T, "spatial_size": [S, S], "n_pokes": 2},
            "testing": {"n_samples_per_data_point": 2}, "logging": {"n_log_images": 3}}


def _flows(seed, n):
    """n tables of flow maps (B, S, S, 2), a few px in size, near each other
    (every error category between 0 and 1)."""
    rng = np.random.default_rng(seed)
    base = 3.0 * rng.standard_normal((B, S, S, 2))
    return [(base + 2.0 * rng.standard_normal(base.shape)).astype(np.float32)
            for _ in range(n)]


class _JaxThirdRun:
    """What the JAX package's third-stage modes read of an experiment; the
    closures return the tables' flows in call order."""

    debug, evaluates_hallucinated_flow = True, True
    logger = SimpleNamespace(info=lambda msg: None)

    def __init__(self, tables, batches, out):
        self.config, self.datamodule = Config(MODE_CFG), _Data(batches)
        self.dirs, self.frozen = {"generated": out}, {}
        self.state = SimpleNamespace(params={})
        self.store = SimpleNamespace(restore_best=lambda s: s)
        self.tables = tables

    def build(self):
        pass

    def next_rng(self):
        return None

    def fns(self, _):
        def pop(key):
            return lambda *args: jnp.asarray(self.tables[key].pop(0))
        return pop("extract"), pop("sample"), pop("recon")


class _PortThirdRun:
    debug, device, evaluates_hallucinated_flow, generator = True, torch.device("cpu"), True, None
    logger = _JaxThirdRun.logger

    def __init__(self, tables, batches, out):
        self.config, self.datamodule = Config(MODE_CFG), _Data(batches)
        self.dirs, self.tables = {"generated": out}, tables

    def build(self):
        pass

    def restore(self, name=None):
        pass

    def batches(self, loader):
        return ({k: torch.as_tensor(v) for k, v in b.items()} for b in loader)

    def fns(self, _):
        def pop(key):
            return lambda *args, **kw: torch.as_tensor(self.tables[key].pop(0))
        return pop("extract"), pop("sample"), pop("recon")


@pytest.mark.parametrize("mode", ["realism", "accuracy"])
def test_third_stage_modes_match_jax(mode, weights_env, tmp_path, monkeypatch):  # noqa: F811
    for k, v in weights_env.items():
        monkeypatch.setenv(k, v)
    batches = []
    for i in range(2):
        b = jax_make_batch(np.random.default_rng(30 + i), batch_size=B, n_frames=T,
                           spatial_size=S)
        batches.append({"images": b["images"], "poke": b["poke"], "flow": _flows(40 + i, 1)[0]})
    n = {"extract": 2, "sample": 4, "recon": 2}
    tables = {k: _flows(50 + i, v) for i, (k, v) in enumerate(n.items())}
    jrun = _JaxThirdRun(copy.deepcopy(tables), batches, str(tmp_path / "jax"))
    prun = _PortThirdRun(copy.deepcopy(tables), batches, str(tmp_path / "port"))
    monkeypatch.setattr(jtesting, "_third_stage_fns", jrun.fns)
    monkeypatch.setattr(ttesting, "_third_stage_fns", prun.fns)
    with jax.disable_jit():
        want = jtesting.run_test(jrun, mode)
    got = ttesting.run_test(prun, mode)
    used = {"realism": {"extract": 2}, "accuracy": n}[mode]
    for run in (jrun, prun):
        assert all(len(run.tables[k]) == n[k] - used.get(k, 0) for k in n)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5 if mode == "realism" else 0,
                                   err_msg=k)
    if mode == "realism":
        assert got["n_samples"] == 2 * B and got["FID"] > 0
    else:
        assert 0 < got["EE_R1"] < 1 and got["EE_R5"] < got["EE_R1"]
    files = sorted(os.listdir(tmp_path / "port" / mode))
    assert files == sorted(os.listdir(tmp_path / "jax" / mode))
    for f in files:
        a, w = (str(tmp_path / side / mode / f) for side in ("port", "jax"))
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(w), err_msg=f)
        elif f.endswith(".yaml"):
            import yaml

            with open(a) as fa, open(w) as fw:
                ya, yw = yaml.safe_load(fa), yaml.safe_load(fw)
            assert len(ya) == len(yw) == 2
            for ea, ew in zip(ya, yw):
                assert ea.keys() == ew.keys()
                np.testing.assert_allclose([ea[k] for k in ew], [ew[k] for k in ew], rtol=0)
    if mode == "accuracy":
        stack = np.load(str(tmp_path / "port" / mode / "samples_diversity_2_pokes.npy"))
        assert stack.shape == (2 + 2, 2 * 3, S, S, 3) and stack.dtype == np.uint8


def test_plots_match_jax(tmp_path):
    """``make_nn_var_plot``'s CSV as the JAX package's (pandas) writes it
    and its PDF; ``make_two_axes_plot`` and ``make_violin_plot`` draw
    their figures."""
    import cv2

    from ipoke_tpu.utils import plots as jplots
    from ipoke_tpu_torch.utils import plots as tplots

    rng = np.random.default_rng(0)
    nn_err, std = rng.uniform(size=6), rng.uniform(0.01, 0.1, size=6)
    paths = []
    for lib, side in ((jplots, "jax"), (tplots, "port")):
        paths.append(lib.make_nn_var_plot(3, nn_err, str(tmp_path / side), std))
    assert [os.path.basename(p) for p in paths] == ["keypoint_err_3_pokes.pdf"] * 2
    with open(tmp_path / "port" / "keypoint_err_data_3_pokes.csv") as a, \
            open(tmp_path / "jax" / "keypoint_err_data_3_pokes.csv") as w:
        assert a.read() == w.read()
    assert open(paths[1], "rb").read(5) == b"%PDF-"
    data = {"Number of Pokes": np.repeat([1, 2, 5], 4),
            "Mean MSE per Frame": rng.uniform(size=12), "Std per Frame": rng.uniform(size=12)}
    tplots.make_two_axes_plot(data, str(tmp_path / "two.png"), title="iPER")
    violin = {"Method": np.repeat(["a", "b", "ours"], 20),
              "Mean Squared KP Error": np.concatenate([rng.normal(m, 1.0, 20) for m in (3, 5, 1)])}
    violin["Mean Squared KP Error"][0] = 1e3  # cut by the z-score filter
    tplots.make_violin_plot(str(tmp_path / "violin.png"), violin, order=["a", "b", "ours"])
    for name in ("two.png", "violin.png"):
        img = cv2.imread(str(tmp_path / name))
        assert img is not None and img.shape[0] > 100 and (img < 250).any(), name
