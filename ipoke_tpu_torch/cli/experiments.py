"""Experiment orchestration (counterpart of ``ipoke_tpu/cli/experiments.py``).

``Experiment`` owns the seed, the versioned run dir, the metrics log, the
train/val loop and the metric-gated checkpoints, as the JAX package's does:

* a new version per run; ``--resume`` and ``--target_version`` attach to
  an existing one, whose ``last`` checkpoint the run continues from (the
  step count, the optimizers' counts and moments, fp32 masters);
* the loop reads ``StaticDataModule``'s threaded loader through
  ``device_prefetch`` (pinned memory, copies on a side CUDA stream), checks
  the metrics for NaN every 10th step, logs every 50th with a step-time
  EMA, and after each epoch validates and saves ``last`` and the monitored
  checkpoint with a ``*_weights`` sidecar (``export_weights``);
* ``general.profiler`` traces steps 10-14 of the first epoch with
  ``torch.profiler`` into ``<log>/<version>/profile``.

Each experiment builds its nets with random weights drawn on the CPU from
``general.seed`` (``init_generator``: the same weights on every device),
moves them to the run's device, and builds its trainer from
``ipoke_tpu_torch.train`` or ``models.image_ae``.  ``checkpoint_state`` / ``load_checkpoint_state`` give
and take the whole train state; ``_resume_template`` brings the freshly
built state to the form a trained run holds (e.g. bf16 params with fp32
masters) before it is loaded.  The steps' and validation's random draws
come from one ``torch.Generator`` on the device (``generator``), seeded by
``general.seed``.

``timings`` keeps what each step, validation and save took (the loader's
wait, the step closed by a synchronize and the wait in that synchronize,
the device allocations so far, checkpoint bytes) for the caller.

Registry names match the JAX package's; the FC experiments and both third
stages live in ``cli/fc_experiments.py``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import entry
from ..core.checkpoint import CheckpointStore, latest_version, next_version
from ..core.config import Config, load_config
from ..core.optim import (
    cast_floats,
    gan_adam,
    with_grad_accumulation,
)
from ..data.datamodule import StaticDataModule, device_prefetch


def get_logger(name="ipoke_tpu_torch"):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class MetricsLogger:
    """JSONL metrics sink (``<log>/<version>/metrics.jsonl``); wandb hooks in
    if asked for and installed."""

    def __init__(self, log_dir: str, use_wandb: bool = False, config=None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(
                    project="ipoke_tpu", config=config, dir=log_dir
                )
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict[str, Any], step: int):
        rec = {"step": int(step)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.wandb is not None:
            self.wandb.log(rec, step=step)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self.wandb is not None:
            try:
                self.wandb.finish()
            except Exception:
                pass
            self.wandb = None


def _written_bytes(paths) -> int:
    """The bytes of the files under ``paths``, each file (inode) once: a
    monitored checkpoint's hard links to ``last`` are not written again."""
    seen = {}
    for path in paths:
        for d, _, files in os.walk(path):
            for f in files:
                st = os.stat(os.path.join(d, f))
                seen[(st.st_dev, st.st_ino)] = st.st_size
    return sum(seen.values())


class Experiment:
    monitor = "loss"
    monitor_mode = "min"
    datakeys = ["images"]

    def __init__(self, config: Config, dirs: Dict[str, str],
                 data_root: Optional[str] = None, meta=None,
                 device="cuda"):
        self.prepare_config(config)
        self.config = config
        self.dirs = dirs
        self.logger = get_logger()
        self.device = torch.device(device)
        gen = config.get("general", {})
        self.debug = bool(gen.get("debug", False))
        self.seed = int(gen.get("seed", 42))
        np.random.seed(self.seed)
        torch.manual_seed(self.seed)
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        self.init_generator = torch.Generator().manual_seed(self.seed)

        # versioned run dir; test mode and resume attach to an existing
        # version (--target_version pins one)
        resume = bool(gen.get("resume", False))
        test_mode = gen.get("test", "none") not in (None, "none")
        if gen.get("target_version") is not None:
            self.version = int(gen["target_version"])
        elif resume or test_mode:
            v = latest_version(dirs["ckpt"])
            assert v is not None, "no existing run version to attach to"
            self.version = v
        else:
            self.version = next_version(dirs["ckpt"])
        self.version_dir = os.path.join(dirs["ckpt"], str(self.version))
        self.store = CheckpointStore(
            self.version_dir, monitor=self.monitor,
            save_top_k=config.get_path("logging.n_saved_ckpt", 3),
            mode=self.monitor_mode,
        )
        self.metrics_logger = MetricsLogger(
            os.path.join(dirs["log"], str(self.version)),
            use_wandb=not self.debug and bool(gen.get("wandb", False)),
            config=config.to_dict(),
        )
        config.save(os.path.join(dirs["config"], f"{self.version}.yaml"))

        tcfg = config["training"]
        self.n_epochs = 2 if self.debug else int(tcfg.get("n_epochs", 100))
        self.max_batches = 10 if self.debug else int(
            tcfg.get("max_batches_per_epoch", 10**9)
        )
        self.max_val_batches = 2 if self.debug else int(
            tcfg.get("max_val_batches", 100)
        )
        if self.debug:  # the trainers' schedules read the run's length here
            tcfg.update(n_epochs=self.n_epochs, max_batches_per_epoch=self.max_batches,
                        max_val_batches=self.max_val_batches)
        dcfg = dict(config["data"])
        if self.debug:
            dcfg["batch_size"] = min(int(dcfg.get("batch_size", 2)), 2)
            dcfg["n_workers"] = 2
        self.datamodule = StaticDataModule(
            dcfg, self.datakeys, data_root=data_root, meta=meta
        )
        self.batch_size = int(dcfg.get("batch_size", 2))
        self.resume = resume
        self.step = 0
        # per step: the host's wait at the step's closing synchronize (near
        # 0 when the card waits on the host) and the allocations so far
        self.timings = {"step_s": [], "loader_wait_s": [], "drain_s": [],
                        "device_allocs": [], "val_s": [], "save_s": [],
                        "save_bytes": [], "restore_s": None}

    def materialize(self, module):
        """``module`` (built on ``meta``) with random weights drawn on the
        CPU from ``init_generator``, on the run's device."""
        return entry.materialize(module, "cpu", self.init_generator).to(self.device)

    def accumulate(self, tx):
        """Gradient accumulation to reach ``training.min_acc_batch_size``
        (reference experiments/experiment.py:81-82)."""
        tx, k = with_grad_accumulation(tx, self.config, self.batch_size)
        if k > 1:
            self.logger.info(f"gradient accumulation: {k} microbatches/update")
        return tx

    # -- subclass API ------------------------------------------------------
    def prepare_config(self, config) -> None:
        """Set the keys this experiment derives from ``config`` before the
        run is set up (the poke encoders' input and target keys)."""

    def build(self):
        raise NotImplementedError

    def train_step(self, batch, epoch: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def validate(self, epoch: int) -> Dict[str, float]:
        raise NotImplementedError

    def checkpoint_state(self) -> dict:
        """The train state to save (``step`` is added by the loop)."""
        raise NotImplementedError

    def load_checkpoint_state(self, state: dict) -> None:
        raise NotImplementedError

    def export_weights(self):
        """Model-only tree for cross-stage loading."""
        return None

    def load_tx(self, tx, state) -> None:
        """``tx``'s saved state; None (a run made from the reference's
        weights, ``reference.write_run``, which hold no optimizer) leaves
        the optimizer fresh: its moments and its schedule's count at 0.  A
        converted JAX run carries its optimizer
        (``tools/jax_run_to_torch.py``)."""
        if state is None:
            self.logger.info("no optimizer state in the checkpoint: the "
                             "optimizer starts fresh")
        else:
            tx.load_state_dict(state)

    def _resume_template(self) -> None:
        """Bring the built state to the form a trained checkpoint holds
        before it is loaded; subclasses whose trained state differs from
        the freshly built one override this."""

    # -- loops ---------------------------------------------------------------
    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_allocs(self) -> int:
        """The device allocations (``cudaMalloc``) the caching allocator
        has made so far; 0 off the card."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.memory_stats(self.device).get("num_device_alloc", 0))

    def batches(self, loader):
        return device_prefetch(loader, self.device)

    def val_batches(self, epoch: int):
        return self.batches(self.datamodule.val_loader(
            epoch=epoch, n_batches=self.max_val_batches))

    def check_finite(self, metrics, epoch: int, step: int):
        """NaN/divergence guard (reference ``terminate_on_nan``)."""
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            if not np.isfinite(fv):
                raise FloatingPointError(
                    f"non-finite train metric {k}={fv} at epoch {epoch} "
                    f"step {step}; aborting (terminate_on_nan)"
                )

    def train(self):
        try:
            return self._train_loop()
        finally:
            self.metrics_logger.close()

    def restore(self, name: Optional[str] = None) -> None:
        """Load the checkpoint ``name`` of this run (the monitored best
        without one) into the built state, brought first to the form a
        trained run holds (``_resume_template``); the step goes on from it."""
        t0 = time.perf_counter()
        self._resume_template()
        state = self.store.restore(name, map_location=self.device) if name \
            else self.store.restore_best(map_location=self.device)
        self.load_checkpoint_state(state)
        self.step = int(state["step"])
        self.sync()
        self.timings["restore_s"] = time.perf_counter() - t0
        self.logger.info(f"restored {self.version_dir}/{name or 'best'} at "
                         f"step {self.step}")

    def restore_last(self):
        self.restore("last")

    def _train_loop(self):
        self.build()
        if self.resume:
            self.restore_last()
        profile = bool(self.config.get_path("general.profiler", False))
        profile_dir = os.path.join(self.dirs["log"], str(self.version),
                                   "profile")
        prof = None
        t_start = time.time()
        step_time_ema = None
        for epoch in range(self.n_epochs):
            it = iter(self.batches(self.datamodule.train_loader(
                epoch=epoch, n_batches=self.max_batches)))
            local = 0
            while True:
                t_wait = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t0 = time.perf_counter()
                self.timings["loader_wait_s"].append(t0 - t_wait)
                # torch.profiler trace of steps 10..14 of the first epoch
                if profile and epoch == 0 and local == 10:
                    prof = _start_profile(self.device)
                metrics = self.train_step(batch, epoch)
                t_queued = time.perf_counter()
                self.sync()
                dt = time.perf_counter() - t0
                self.timings["step_s"].append(dt)
                self.timings["drain_s"].append(dt - (t_queued - t0))
                self.timings["device_allocs"].append(self.device_allocs())
                step_time_ema = dt if step_time_ema is None else (
                    0.9 * step_time_ema + 0.1 * dt)
                if prof is not None and local == 14:
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.stop()
                    prof.export_chrome_trace(os.path.join(profile_dir,
                                                          "trace.json"))
                    prof = None
                    self.logger.info(f"profile trace in {profile_dir}")
                local += 1
                self.step += 1
                if self.step % 10 == 1:
                    self.check_finite(metrics, epoch, self.step)
                if self.step % 50 == 1:
                    metrics = dict(metrics)
                    metrics["step_time_s"] = step_time_ema
                    self.metrics_logger.log(
                        {f"train/{k}": v for k, v in metrics.items()}, self.step
                    )
                    self.logger.info(
                        f"epoch {epoch} step {self.step}: " + ", ".join(
                            f"{k}={float(v):.4f}" for k, v in list(
                                metrics.items())[:6]
                        )
                    )
            if prof is not None:  # an epoch shorter than 15 steps
                prof.stop()
                prof = None
            t0 = time.perf_counter()
            val_metrics = self.validate(epoch)
            self.sync()
            self.timings["val_s"].append(time.perf_counter() - t0)
            self.metrics_logger.log(
                {f"val/{k}": v for k, v in val_metrics.items()}, self.step
            )
            self.save(val_metrics.get(self.monitor))
            self.logger.info(
                f"epoch {epoch} done ({time.time() - t_start:.0f}s): "
                + ", ".join(f"{k}={v:.4f}" for k, v in val_metrics.items())
            )
        return self

    def save(self, monitor_val):
        t0 = time.perf_counter()
        state = dict(self.checkpoint_state(), step=self.step)
        saved = self.store.save(state, step=self.step, metric=monitor_val,
                                weights=self.export_weights())
        self.timings["save_s"].append(time.perf_counter() - t0)
        paths = [self.store._path("last"), self.store._path("last_weights")]
        if saved is not None:
            paths += [saved, saved + "_weights"]
        self.timings["save_bytes"].append(_written_bytes(paths))


def _start_profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _metrics_mean(chunks) -> float:
    return float(np.mean(np.concatenate(chunks)))


class FirstStageExperiment(Experiment):
    """Video VAE-GAN (reference experiments/first_stage_video.py) over
    ``train.FirstStageTrainer``."""

    monitor = "FVD-val"
    datakeys = ["images", "poke", "flow"]

    def build(self):
        from ..train import FirstStageTrainer

        cfg = self.config
        self.model, self.disc_s, self.disc_t, self.vgg = (
            net.to(self.device) for net in entry.build_first_stage(
                cfg, "cpu", self.init_generator))
        self.trainer = FirstStageTrainer(
            cfg, self.model, self.disc_s, self.disc_t, self.vgg,
            wrap=self.accumulate)
        self.tx = self.trainer.tx[0]

    def train_step(self, batch, epoch):
        return self.trainer.train_step(batch, epoch, self.generator)

    def checkpoint_state(self):
        return {"model": self.model.state_dict(),
                "disc_s": self.disc_s.state_dict(),
                "disc_t": self.disc_t.state_dict(),
                "tx": [tx.state_dict() for tx in self.trainer.tx]}

    def load_checkpoint_state(self, state):
        self.model.load_state_dict(state["model"])
        self.disc_s.load_state_dict(state["disc_s"])
        self.disc_t.load_state_dict(state["disc_t"])
        for i, tx in enumerate(self.trainer.tx):
            self.load_tx(tx, None if state["tx"] is None else state["tx"][i])

    def export_weights(self):
        return self.model.state_dict()

    @torch.no_grad()
    def validate(self, epoch):
        from ..eval import (compute_fvd, init_fvd_backbone,
                            perceptual_distance, psnr, ssim)

        if not hasattr(self, "_fvd_net"):
            self._fvd_net = init_fvd_backbone(self.device)
        from ..models.first_stage import latent_shape

        shape = latent_shape(self.config)
        ssims, psnrs, lpips_vals, reals, fakes = [], [], [], [], []
        for batch in self.val_batches(epoch):
            X = batch["images"]
            # the JAX validation samples the posterior (apply with an rng)
            noise = torch.randn((X.shape[0], *shape), generator=self.generator,
                                device=X.device)
            # bf16 under mixed_prec: the metrics take it upcast, as the
            # JAX package's promote it against the fp32 batch.  The PokeVAE
            # decodes under the batch's poke (the JAX validation applies it
            # without one and fails: ROADMAP §3)
            poke = {"poke": batch["poke"]} if getattr(self.model, "needs_poke", False) \
                else {}
            X_hat = self.model(X, train=False, noise=noise, **poke)[0].float()
            a = X[:, 1:].reshape(-1, *X.shape[2:])
            b = X_hat.reshape(-1, *X_hat.shape[2:])
            ssims.append(ssim(a, b).cpu().numpy())
            psnrs.append(psnr(a, b).cpu().numpy())
            lpips_vals.append(perceptual_distance(self.vgg, a, b).cpu().numpy())
            reals.append(X[:, 1:].cpu())
            fakes.append(X_hat.cpu())
        n = sum(r.shape[0] for r in reals)
        fvd = compute_fvd(self._fvd_net, torch.cat(reals), torch.cat(fakes),
                          batch_size=min(8, n))
        return {
            "FVD-val": float(fvd),
            "ssim-val": _metrics_mean(ssims),
            "psnr-val": _metrics_mean(psnrs),
            "lpips-val": _metrics_mean(lpips_vals),
        }


class _AEExperiment(Experiment):
    """Shared conditioner / poke-embedder trainer (``models.image_ae``)."""

    monitor = "lpips-val"
    use_disc = True
    # FID between real and reconstructed images during validation (the
    # reference's image AE, first_stage_image_conv.py:223-256)
    fid_val = False

    def build_ae(self, config):
        """The ``ImageAE`` to train (on ``meta``)."""
        from ..models.image_ae import build_image_ae

        return build_image_ae(config)

    def weight_decay(self, config) -> float:
        return float(config["training"].get("weight_decay", 1e-5))

    def build(self):
        from ..models.image_ae import (
            build_image_disc,
            create_image_ae_state,
            make_image_ae_train_step,
        )

        cfg = self.config
        with torch.device("meta"):
            model, disc = self.build_ae(cfg), build_image_disc(cfg)
        self.model = self.materialize(model)
        with torch.no_grad():
            self.model.logvar.zero_()
        self.disc = self.materialize(disc) if self.use_disc else None
        self.vgg = entry.build_vgg(self.device)
        lr = float(cfg["training"].get("lr", 2e-4))
        wd = self.weight_decay(cfg)
        self.tx, self.tx_d = create_image_ae_state(
            self.model, self.disc,
            lambda params: self.accumulate(gan_adam(params, lr, wd)),
            use_disc=self.use_disc)
        self._step = make_image_ae_train_step(
            cfg, self.model, self.disc, self.vgg, self.tx, self.tx_d,
            use_disc=self.use_disc)
        self.disc_start = int(cfg.get("disc", {}).get("start", 0))

    def disc_gate(self, epoch: int) -> float:
        return 1.0 if (self.use_disc and epoch >= self.disc_start) else 0.0

    def train_step(self, batch, epoch):
        return self._step(batch, self.disc_gate(epoch), generator=self.generator)

    def checkpoint_state(self):
        state = {"model": self.model.state_dict(), "tx": self.tx.state_dict()}
        if self.use_disc:
            state.update(disc=self.disc.state_dict(), tx_d=self.tx_d.state_dict())
        return state

    def load_checkpoint_state(self, state):
        self.model.load_state_dict(state["model"])
        self.load_tx(self.tx, state["tx"])
        if self.use_disc:
            self.disc.load_state_dict(state["disc"])
            self.load_tx(self.tx_d, state["tx_d"])

    def export_weights(self):
        return self.model.ae.state_dict()

    @torch.no_grad()
    def validate(self, epoch):
        from ..eval import compute_fid, perceptual_distance, psnr, ssim
        from ..models.image_ae import pad3

        lp, ss, ps, reals, recs = [], [], [], [], []
        for batch in self.val_batches(epoch):
            x, tgt = self._step.io(batch)
            # a variational AE: the JAX validation samples (apply with an rng)
            rec = self.model.ae(x, train=False,
                                noise=self._step.noise(x, self.generator))
            a, b = (tgt, rec) if tgt.shape[-1] == 3 else (pad3(tgt), pad3(rec))
            lp.append(perceptual_distance(self.vgg, a, b).cpu().numpy())
            ss.append(ssim(a, b).cpu().numpy())
            ps.append(psnr(a, b).cpu().numpy())
            if self.fid_val:
                reals.append(a)
                recs.append(b)
        out = {"lpips-val": _metrics_mean(lp), "ssim-val": _metrics_mean(ss),
               "psnr-val": _metrics_mean(ps)}
        if self.fid_val:
            real = torch.cat(reals)
            out["fid-val"] = float(compute_fid(
                self.vgg, real, torch.cat(recs),
                batch_size=min(32, real.shape[0])))
        return out


class ImgEncoderExperiment(_AEExperiment):
    datakeys = ["images"]
    fid_val = True


class PokeEncoderExperiment(_AEExperiment):
    datakeys = ["images", "poke", "flow"]
    use_disc = False

    def prepare_config(self, config) -> None:
        config["input_key"] = "flow" if config.get_path(
            "architecture.flow_ae", False) else "poke"
        config["target_key"] = "flow"


def load_frozen_net(config, section: str, build, generator):
    """The frozen net of ``config[section]``, on the CPU: built by
    ``build(sub_config)`` from its own config (``<section>.config``, a path
    or a tree), loaded from the best ``*_weights`` of its run
    (``<section>.ckpt``; random weights from the CPU ``generator`` without
    one), then frozen: spectral norms collapsed, eval, no grad.  Weights
    saved frozen (no spectral-norm ``u``, as ``reference.write_run`` saves
    the paper's) load into the net frozen first."""
    from ..models.image_ae import freeze_spectral_norm
    from ..models.pretrained_registry import resolve

    sec = resolve(section, dict(config[section]))
    sub_cfg = load_config(sec["config"]) if isinstance(
        sec.get("config"), str) else Config(sec.get("config", {}))
    with torch.device("meta"):
        net = build(sub_cfg)
    net = entry.materialize(net, "cpu", generator)
    if sec.get("ckpt"):
        weights = CheckpointStore(sec["ckpt"]).restore_best(weights=True)
        if not any(k.endswith(".u") for k in weights):
            freeze_spectral_norm(net)
        net.load_state_dict(weights)
    return freeze_spectral_norm(net).eval().requires_grad_(False)


def load_frozen(config, generator):
    """The three frozen submodels (first stage, conditioner, poke embedder)
    of a second- or third-stage config (``load_frozen_net``); the
    conditioner is None under ``conditioner.use: false``."""
    from ..models import first_stage as fs
    from ..models.image_ae import build_image_ae

    first = load_frozen_net(config, "first_stage",
                            lambda c: fs.build_first_stage(c)[0], generator)
    cond = None
    if config.get_path("conditioner.use", True):
        cond = load_frozen_net(config, "conditioner",
                               lambda c: build_image_ae(c).ae, generator)
    poke = load_frozen_net(config, "poke_embedder", lambda c: build_image_ae(c).ae,
                           generator)
    return first, cond, poke


class SecondStageExperiment(Experiment):
    """cINN over the frozen first stage and encoders (reference
    experiments/second_stage_video.py) over ``train.SecondStageTrainer``.

    DDI runs in fp32 on the first batch of a fresh run only (a restored
    state has step > 0); under ``mixed_prec_master`` the model is then cast
    to bf16 and the optimizer built over the post-DDI masters
    (``SecondStageTrainer.start``).  The bf16 NICE couplings run K4 (with K1
    in the no-grad pass of each checkpointed step): ``fused_nice_train``."""

    monitor = "FVD-val"
    datakeys = ["images", "poke", "flow"]

    def build(self):
        from ..models.second_stage import SecondStageModel
        from ..train import SecondStageTrainer, run_lr_schedule
        from ..flows import ParamTree

        cfg = self.config
        first, cond, poke = load_frozen(cfg, self.init_generator)
        self.model = SecondStageModel(cfg, first, cond, poke)
        self.model.flow_params = ParamTree(
            self.model.init_params(self.init_generator, "cpu"))
        self.model.to(self.device)
        tcfg = cfg["training"]
        self.trainer = SecondStageTrainer(
            self.model,
            run_lr_schedule(tcfg, tcfg.get("custom_lr_decrease", True)),
            clip_grad_norm=float(tcfg.get("clip_grad_norm", 0) or 0),
            wrap=self.accumulate)
        self._mixed = self.trainer.mixed
        self.ddi_runs = 0

    @property
    def tx(self):
        return self.trainer.tx

    def _resume_template(self):
        # a trained run holds bf16 params under mixed_prec_master, with the
        # fp32 masters in the optimizer: cast and build it so, then load
        self.trainer.start()

    def train_step(self, batch, epoch):
        if self.trainer.tx is None:
            # a fresh run: fp32 DDI on this batch, then the bf16 cast and the
            # optimizer over the post-DDI values
            self.trainer.ddi(batch, self.generator)
            self.ddi_runs += 1
            self.trainer.start()
        return self.trainer.train_step(batch, self.generator)

    def checkpoint_state(self):
        return {"flow": self.model.flow_params.state_dict(),
                "tx": self.trainer.tx.state_dict()}

    def load_checkpoint_state(self, state):
        self.model.flow_params.load_state_dict(state["flow"])
        self.load_tx(self.trainer.tx, state["tx"])

    def export_weights(self):
        return self.model.flow_params.state_dict()

    @torch.no_grad()
    def validate(self, epoch):
        from ..eval import compute_fvd, init_fvd_backbone
        from ..flows import flow_loss

        if not hasattr(self, "_fvd_net"):
            self._fvd_net = init_fvd_backbone(self.device)
        T = self.config["data"]["max_frames"]
        nlls, reals, fakes, zs = [], [], [], []
        for batch in self.val_batches(epoch):
            if self._mixed:  # bf16-resident params need bf16 activations
                batch = cast_floats(batch, torch.bfloat16)
            z, logdet = self.model.forward_density(batch, self.generator)
            loss, _ = flow_loss(z, logdet)
            nlls.append(float(loss))
            zs.append(z.float().cpu().numpy())
            vid = self.model.forward_sample(batch, T, self.generator)
            reals.append(batch["images"][:, 1:].float().cpu())
            fakes.append(vid.float().cpu())
        n = sum(r.shape[0] for r in reals)
        fvd = compute_fvd(self._fvd_net, torch.cat(reals), torch.cat(fakes),
                          batch_size=min(8, n))
        # latent diagnostic scatter every 3 epochs (reference log_umap,
        # second_stage_video.py:599-638; PCA here)
        if epoch % 3 == 0:
            from ..utils.latent_viz import plot_latent_scatter

            z_all = np.concatenate(zs)
            ref = np.random.default_rng(epoch).normal(size=z_all.shape)
            out_dir = os.path.join(self.dirs["generated"], "latents")
            os.makedirs(out_dir, exist_ok=True)
            plot_latent_scatter(
                {"flow(z_m)": z_all, "N(0,I)": ref},
                os.path.join(out_dir, f"epoch_{epoch:04d}.png"))
        return {"FVD-val": float(fvd), "flow_loss-val": float(np.mean(nlls))}


def _registry():
    from . import fc_experiments as fc

    return {
        # conv pipeline (reference experiments/__init__.py:14-24)
        "img_encoder": ImgEncoderExperiment,
        "poke_encoder": PokeEncoderExperiment,
        "first_stage": FirstStageExperiment,
        "second_stage": SecondStageExperiment,
        # the FC tower (architecture.fc_baseline selects the FC first stage)
        "img_encoder_fc": fc.ImgEncoderFCExperiment,
        "poke_encoder_fc": fc.PokeEncoderFCExperiment,
        "first_stage_fc": FirstStageExperiment,
        "second_stage_fc": fc.SecondStageFCExperiment,
        "flow_encoder_fc": fc.FlowEncoderFCExperiment,
        "inn_fcae": fc.INNFCAEExperiment,
        # the fork's third stages: FC (its namesake) and conv
        "third_stage_fc": fc.ThirdStageFCExperiment,
        "flow_motion": fc.FlowMotionExperiment,
        "flow_vae": fc.FlowVAEExperiment,
    }


__experiments__ = None


def select_experiment(config: Config):
    global __experiments__
    if __experiments__ is None:
        __experiments__ = _registry()
    name = config.get_path("general.experiment")
    if name not in __experiments__ and isinstance(name, str):
        # the reference registry mixes key casings (`poke_encoder_FC`)
        lowered = name.lower()
        if lowered in __experiments__:
            name = lowered
    assert name in __experiments__, (
        f"unknown experiment {name!r}; choose from {sorted(__experiments__)}"
    )
    return __experiments__[name]
