"""The port's experiment layer against the JAX package's, piece by piece:
the checkpoint store (manifest, names, best path) beside
``ipoke_tpu.core.checkpoint.CheckpointStore``; grad accumulation beside
``optax.MultiSteps``; ``flow_adam``'s clip beside
``optax.clip_by_global_norm``; the experiments' gates and schedules beside
the JAX experiments' by value; and the poke embedder's two steps beside the
jitted ``make_image_ae_train_step`` (this file's one JAX program)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.cli import experiments as jexp
from ipoke_tpu.cli import fc_experiments as jfc
from ipoke_tpu.core import checkpoint as jckpt
from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.config import Config
from ipoke_tpu.models import third_stage as jts
from ipoke_tpu_torch.cli import experiments as texp
from ipoke_tpu_torch.core import checkpoint as tckpt
from ipoke_tpu_torch.core import optim as toptim
from ipoke_tpu_torch.models import third_stage as tts
from ipoke_tpu_torch.train import FirstStageTrainer, FlowMotionTrainer, run_lr_schedule

from test_torch_image_ae import check_image_ae_steps
from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

K = jax.random.PRNGKey


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["min", "max"])
def test_checkpoint_store_matches_jax(tmp_path, mode):
    """The same ``save(step, metric)`` calls leave the same manifest (names
    and values), the same surviving checkpoints and the same best path."""
    j = jckpt.CheckpointStore(str(tmp_path / "jax"), monitor="FVD-val",
                              save_top_k=2, mode=mode)
    t = tckpt.CheckpointStore(str(tmp_path / "port"), monitor="FVD-val",
                              save_top_k=2, mode=mode)
    for step, metric in ((10, 3.0), (20, 1.25), (30, 2.0), (40, 0.5),
                         (50, 4.0), (60, 2.0004)):
        tree = {"w": np.full(3, step, np.float32)}
        sj = j.save(tree, step, metric, weights=tree)
        st = t.save({"w": torch.full((3,), float(step))}, step, metric,
                    weights={"w": torch.zeros(1)})
        assert os.path.basename(st) == os.path.basename(sj)
        mj, mt = j._load_manifest(), t._load_manifest()
        assert {os.path.basename(k): v for k, v in mt.items()} == \
            {os.path.basename(k): v for k, v in mj.items()}
        assert sorted(os.listdir(t.dir)) == sorted(os.listdir(j.dir))
        assert os.path.basename(t.best_path()) == os.path.basename(j.best_path())
    best = t.restore_best()
    want = t._load_manifest()[t.best_path()]
    assert float(best["w"][0]) == {"min": 40, "max": 50}[mode]
    assert want == {"min": 0.5, "max": 4.0}[mode]
    assert float(t.restore_best(weights=True)["w"][0]) == 0.0


def test_checkpoint_restore_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"step": 7, "flow": {"a": torch.randn(5, 3, generator=g).bfloat16(),
                                 "buf_perm": torch.randperm(6, generator=g)},
             "tx": {"count": 3, "master": [torch.randn(4, generator=g)],
                    "adam": {"state": {0: {"step": torch.tensor(3.0)}},
                             "param_groups": [{"lr": 0.0, "betas": (0.9, 0.999),
                                               "amsgrad": True, "params": [0]}]}}}
    store = tckpt.CheckpointStore(str(tmp_path), monitor="loss")
    store.save(state, step=7, metric=1.0)
    for got in (store.restore("last"), store.restore_best()):
        assert got["step"] == 7 and got["tx"]["count"] == 3
        for a, b in ((got["flow"]["a"], state["flow"]["a"]),
                     (got["flow"]["buf_perm"], state["flow"]["buf_perm"]),
                     (got["tx"]["master"][0], state["tx"]["master"][0])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert got["tx"]["adam"]["param_groups"] == state["tx"]["adam"]["param_groups"]


def test_monitored_checkpoint_is_written_once(tmp_path):
    """A monitored checkpoint saved with ``last`` is ``last``'s file (and
    sidecar) under a second name, counted once in the bytes a save wrote;
    the next ``last`` is a new file and the monitored one keeps its state."""
    from ipoke_tpu_torch.cli.experiments import _written_bytes

    store = tckpt.CheckpointStore(str(tmp_path), monitor="loss")
    first = store.save({"w": torch.ones(256)}, step=1, metric=1.0,
                       weights={"w": torch.ones(2)})
    paths = [store._path("last"), store._path("last_weights"), first, first + "_weights"]
    for name in ("", "_weights"):
        assert os.path.samefile(os.path.join(store._path("last" + name), "state.pt"),
                                os.path.join(first + name, "state.pt"))
    once = sum(os.path.getsize(os.path.join(p, "state.pt")) for p in paths[:2])
    assert _written_bytes(paths) == once
    store.save({"w": torch.zeros(256)}, step=2, metric=2.0)
    assert not os.path.samefile(os.path.join(store._path("last"), "state.pt"),
                                os.path.join(first, "state.pt"))
    assert torch.equal(store.restore_best()["w"], torch.ones(256))
    assert torch.equal(store.restore("last")["w"], torch.zeros(256))


def test_run_dirs_match_jax(tmp_path):
    dj = jckpt.create_dir_structure(str(tmp_path / "j"), "second_stage", "m")
    dt = tckpt.create_dir_structure(str(tmp_path / "t"), "second_stage", "m")
    assert {k: os.path.relpath(v, tmp_path / "j") for k, v in dj.items()} == \
        {k: os.path.relpath(v, tmp_path / "t") for k, v in dt.items()}
    for v in ("0", "1", "3"):
        os.makedirs(os.path.join(dt["ckpt"], v))
    with open(os.path.join(dt["ckpt"], "1", "last"), "w"):
        pass
    assert tckpt.next_version(dt["ckpt"]) == jckpt.next_version(dt["ckpt"]) == 4
    assert tckpt.latest_version(dt["ckpt"]) == jckpt.latest_version(dt["ckpt"]) == 1


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _toy(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]


def _run_both(jtx, ttx_of, grads, p0):
    """Apply ``grads`` (a list of per-call gradient lists) through the JAX
    transformation and the port's optimizer; yields both params after each
    call."""
    params = [jnp.asarray(p) for p in p0]
    opt = jtx.init(params)
    port = [torch.tensor(p) for p in p0]
    ttx = ttx_of(port)
    for g in grads:
        upd, opt = jtx.update([jnp.asarray(x) for x in g], opt, params)
        params = optax.apply_updates(params, upd)
        for q, x in zip(port, g):
            q.grad = torch.tensor(x)
        ttx.step()
        yield [np.asarray(a) for a in params], [q.detach().numpy().copy() for q in port], ttx


def test_grad_accumulation_matches_optax_multisteps():
    """k = ceil(6 / 2) = 3 microbatches per update of ``flow_adam`` on a
    warmup schedule: params within 1e-6 after every microbatch, unchanged
    between updates, and the inner count (the schedule's) once per k."""
    cfg = {"training": {"min_acc_batch_size": 6}}
    sched_j = joptim.warmup_linear_decay(1e-2, 2, 10)
    jtx, kj = joptim.with_grad_accumulation(joptim.flow_adam(sched_j), cfg, 2)
    p0 = _toy(0)
    rng = np.random.default_rng(1)
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
             for _ in range(12)]
    sched_t = toptim.warmup_linear_decay(1e-2, 2, 10)
    kt = []

    def make(port):
        tx, k = toptim.with_grad_accumulation(toptim.flow_adam(port, sched_t), cfg, 2)
        kt.append(k)
        return tx

    prev = p0
    for i, (pj, pt, ttx) in enumerate(_run_both(jtx, make, grads, p0)):
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        moved = any(not np.array_equal(a, b) for a, b in zip(pt, prev))
        assert moved == ((i + 1) % 3 == 0 and i >= 3)  # lr 0 at count 0
        assert ttx.count == (i + 1) // 3
        prev = pt
    assert kj == kt[0] == 3
    assert toptim.with_grad_accumulation(None, cfg, 8) == (None, 1)


def test_clip_grad_norm_matches_optax():
    """``flow_adam(clip_grad_norm=1.5)`` against the JAX package's (optax's
    ``clip_by_global_norm`` before the coupled decay): gradients above and
    below the clip, params within 1e-6; and the clip alone against
    ``optax.clip_by_global_norm``."""
    p0 = _toy(2)
    rng = np.random.default_rng(3)
    grads = [[(s * rng.standard_normal(p.shape)).astype(np.float32) for p in p0]
             for s in (0.05, 3.0, 0.2, 10.0)]
    jtx = joptim.flow_adam(1e-2, clip_grad_norm=1.5)
    for pj, pt, _ in _run_both(jtx, lambda port: toptim.flow_adam(port, 1e-2, 1.5),
                               grads, p0):
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    clip = optax.clip_by_global_norm(1.5)
    for g in grads:
        want, _ = clip.update([jnp.asarray(x) for x in g], clip.init(None))
        port = [torch.zeros(p.shape) for p in p0]
        tx = toptim._Adam(port, 0.0, (0.9, 0.999), 0.0, False, 1.5)
        for q, x in zip(port, g):
            q.grad = torch.tensor(x)
        seen = []
        tx.adam.step = lambda: seen.extend(q.grad.clone() for q in port)
        tx.step()
        for a, b in zip(seen, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# gates and schedules, by value
# ---------------------------------------------------------------------------

def _shell(cls, **attrs):
    obj = cls.__new__(cls)
    obj.__dict__.update(attrs)
    return obj


def test_disc_gate_and_kl_anneal_match_jax():
    cfg = Config({"training": {"kl_annealing": 3}, "d_t": {"pretrain": 2}})
    j = _shell(jexp.FirstStageExperiment, config=cfg, pretrain=2, state=None,
               rng=K(0), _step=lambda state, batch, rng, gate, kl: (gate, kl))
    t = _shell(FirstStageTrainer, pretrain=2, anneal=3.0)
    for use_disc in (True, False):
        ja = _shell(jexp._AEExperiment, use_disc=use_disc, disc_start=3, state=None,
                    rng=K(0), _step=lambda state, batch, rng, gate: gate)
        ta = _shell(texp._AEExperiment, use_disc=use_disc, disc_start=3)
        for epoch in range(7):
            assert ta.disc_gate(epoch) == float(ja.train_step(None, epoch))
    for epoch in range(7):
        assert t.gates(epoch) == tuple(float(v) for v in j.train_step(None, epoch))


def test_recon_schedule_matches_jax():
    """The recon weight ``FlowMotionExperiment`` trains each epoch with."""
    cfg = Config({"training": {"recon_scaling": True, "weight_recon": 1.5}})
    state = jts.ThirdStageState(params=None, opt=None, step=jnp.zeros((), jnp.int32),
                                weight_recon=jnp.asarray(1.5))
    j = _shell(jfc.FlowMotionExperiment, config=cfg, state=state, frozen=None,
               rng=K(0), _step=lambda state, frozen, batch, rng: state.weight_recon)
    t = _shell(FlowMotionTrainer, recon_scaling=True, weight_recon=1.5,
               state=tts.ThirdStageState(None, 0, 1.5),
               _step=lambda state, batch, gen, noise: (state, state.weight_recon))
    for epoch in (0, 8, 9, 10, 18, 19, 29, 45):
        assert t.train_step(None, epoch) == float(j.train_step(None, epoch))


@pytest.mark.parametrize("custom", [True, False])
def test_lr_totals_match_jax(custom):
    """The second stage's and the bridge's warmup/decay schedules over the
    run (``n_epochs * max_batches_per_epoch``; 10**9 without
    ``custom_lr_decrease``), as ``train.run_lr_schedule`` builds them for
    the experiments, against the JAX experiments' formula and
    ``warmup_linear_decay``."""
    tcfg = Config({"lr": 2e-3, "lr_scaling_max_it": 7, "custom_lr_decrease": custom,
                   "n_epochs": 3, "max_batches_per_epoch": 11})
    ss = run_lr_schedule(tcfg, tcfg["custom_lr_decrease"])
    fm = run_lr_schedule(tcfg)
    want_ss = joptim.warmup_linear_decay(2e-3, 7, 33 if custom else 10**9)
    want_fm = joptim.warmup_linear_decay(2e-3, 7, 33)
    for count in (0, 3, 7, 8, 20, 32, 33, 40):
        np.testing.assert_allclose(ss(count), float(want_ss(count)),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(fm(count), float(want_fm(count)),
                                   rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# the poke embedder
# ---------------------------------------------------------------------------

def test_poke_embedder_steps_match_jax():
    """Poke -> flow, no discriminator: two steps beside the jitted JAX step
    by ``test_torch_image_ae.check_image_ae_steps``'s rule."""
    check_image_ae_steps("poke_embedder")
