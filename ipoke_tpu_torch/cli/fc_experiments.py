"""The fork's experiments (counterpart of ``ipoke_tpu/cli/fc_experiments.py``):

* the FC tower: ``FlowEncoderFCExperiment`` (the BigAE VAE-GAN on flow
  maps, or on frames at ``n_out_channels`` 3), ``ImgEncoderFCExperiment``
  and ``PokeEncoderFCExperiment`` (the FC wrapper as the image AE stage),
  ``SecondStageFCExperiment`` (the flat cINN over the frozen FC first stage
  and encoders; the FC first stage itself trains under
  ``FirstStageExperiment``) and ``INNFCAEExperiment`` (an unconditioned
  flat INN over the frozen flow encoder's latents);
* the FC third stage, the fork's namesake: ``ThirdStageFCExperiment`` (a
  flat INN from the frozen flow encoder's latents to the frozen FC second
  stage's residual, over ``train.ThirdStageFCTrainer``), which the
  ``--test realism`` and third-stage ``--test accuracy`` modes evaluate;
* the conv third stage: ``FlowVAEExperiment`` and ``FlowMotionExperiment``,
  over ``train.FlowVAETrainer`` and ``train.FlowMotionTrainer``."""

from __future__ import annotations

import numpy as np
import torch

from .. import entry
from ..core.checkpoint import CheckpointStore
from ..core.config import Config, load_config
from .experiments import (
    Experiment,
    SecondStageExperiment,
    _AEExperiment,
    load_frozen,
    load_frozen_net,
)


class FlowEncoderFCExperiment(Experiment):
    """The BigAE VAE-GAN (reference ``FCAEModel``), monitored on the
    perceptual distance of its reconstruction (and on flow maps the
    endpoint and angular errors)."""

    monitor = "lpips-val"
    datakeys = ["flow", "images"]

    def build(self):
        from ..core.optim import gan_adam
        from ..models.fc_stack import FCAETrainer, build_big_ae
        from ..nn.discriminators import PatchDiscriminator2D

        cfg = self.config
        dcfg = cfg.get("disc", {})
        with torch.device("meta"):
            model = build_big_ae(cfg)
            disc = PatchDiscriminator2D(dcfg.get("ndf", 64), dcfg.get("n_layers", 3),
                                        cin=model.in_channels)
        self.model, self.disc = self.materialize(model), self.materialize(disc)
        self.vgg = entry.build_vgg(self.device)
        lr = float(cfg["training"].get("lr", 2e-4))
        wd = float(cfg["training"].get("weight_decay", 1e-5))
        make = lambda net: self.accumulate(gan_adam(list(net.parameters()), lr, wd))
        self.tx, self.tx_d = make(self.model), make(self.disc)
        self.trainer = FCAETrainer(cfg, self.model, self.disc, self.vgg, self.tx,
                                   self.tx_d)

    def train_step(self, batch, epoch):
        return self.trainer.train_step(batch, epoch, self.generator)

    def checkpoint_state(self):
        return {"model": self.model.state_dict(), "disc": self.disc.state_dict(),
                "tx": self.tx.state_dict(), "tx_d": self.tx_d.state_dict(),
                "prev_d_loss": self.trainer.step.prev_d_loss}

    def load_checkpoint_state(self, state):
        self.model.load_state_dict(state["model"])
        self.disc.load_state_dict(state["disc"])
        self.tx.load_state_dict(state["tx"])
        self.tx_d.load_state_dict(state["tx_d"])
        self.trainer.step.prev_d_loss = state["prev_d_loss"]

    def export_weights(self):
        return self.model.state_dict()

    @torch.no_grad()
    def validate(self, epoch):
        from ..eval import angular_error, endpoint_error, perceptual_distance
        from ..models.fc_stack import fcae_input
        from ..models.image_ae import pad3

        key = self.trainer.step.key
        lp, ee, ae = [], [], []
        for batch in self.val_batches(epoch):
            x = fcae_input(batch, key)
            # the JAX validation samples the posterior (apply with an rng)
            noise = torch.randn((x.shape[0], self.model.z_dim),
                                generator=self.generator, device=x.device)
            rec = self.model(x, noise)[0]
            a, b = (x, rec) if x.shape[-1] == 3 else (pad3(x), pad3(rec))
            lp.append(perceptual_distance(self.vgg, a, b).cpu().numpy())
            if key == "flow":
                ee.append(endpoint_error(x, rec).mean().item())
                ae.append(angular_error(x, rec).mean().item())
        out = {"lpips-val": float(np.mean(np.concatenate(lp)))}
        if ee:
            out.update({"EE-val": float(np.mean(ee)), "AE-val": float(np.mean(ae))})
        return out


class _FCEncoderExperiment(_AEExperiment):
    """The FC image or poke encoder: ``FirstStageFCWrapper`` trained as the
    image AE stage, with ``gan_adam``'s default weight decay (1e-5) as in
    the JAX experiment."""

    def build_ae(self, config):
        from ..models.fc_baseline import FirstStageFCWrapper
        from ..models.image_ae import ImageAE

        arch = config["architecture"]
        return ImageAE(FirstStageFCWrapper(
            config["data"]["spatial_size"][0], arch.get("nf_in", 3), arch["nf_max"],
            deterministic=arch.get("deterministic", True),
            poke_and_image=arch.get("poke_and_image", False)))

    def weight_decay(self, config) -> float:
        return 1e-5


class ImgEncoderFCExperiment(_FCEncoderExperiment):
    datakeys = ["images"]


class PokeEncoderFCExperiment(_FCEncoderExperiment):
    datakeys = ["images", "poke", "flow"]
    use_disc = False

    def prepare_config(self, config) -> None:
        config["input_key"] = "poke"
        config["target_key"] = "flow"


def load_frozen_fc(config, generator):
    """The frozen FC first stage, conditioner (3 channels) and poke embedder
    (2 channels) of a ``second_stage_fc`` config, the encoders at the
    widths its sections give (``nf_max``, 64 by default), as the JAX
    experiment builds them (``load_frozen_net``)."""
    from ..models import first_stage as fs
    from ..models.fc_baseline import FirstStageFCWrapper

    s = config["data"]["spatial_size"][0]
    first = load_frozen_net(config, "first_stage",
                            lambda c: fs.build_first_stage(c)[0], generator)
    nets = [first]
    for section, nf_in in (("conditioner", 3), ("poke_embedder", 2)):
        nf_max = config[section].get("nf_max", 64)
        nets.append(load_frozen_net(config, section, lambda c: FirstStageFCWrapper(
            s, nf_in, nf_max), generator))
    return tuple(nets)


class SecondStageFCExperiment(SecondStageExperiment):
    """The flat cINN over the frozen FC first stage and encoders (reference
    ``second_stage_video_fc``), fp32, on ``train.SecondStageTrainer``: DDI
    on the first batch of a fresh run only, the warmup / linear-decay
    schedule over the run, AMSGrad; the radial base with
    ``training.base_distribution: radial``.  Monitored on FVD."""

    def build(self):
        from ..flows import ParamTree
        from ..models.fc_baseline import SecondStageModelFC
        from ..train import SecondStageTrainer, run_lr_schedule

        cfg = self.config
        first, cond, poke = load_frozen_fc(cfg, self.init_generator)
        self.model = SecondStageModelFC(cfg, first, cond, poke)
        self.model.flow_params = ParamTree(
            self.model.flow.init(self.init_generator, "cpu"))
        self.model.to(self.device)
        self.trainer = SecondStageTrainer(self.model, run_lr_schedule(cfg["training"]),
                                          wrap=self.accumulate)
        self._mixed = False
        self.ddi_runs = 0

    @torch.no_grad()
    def validate(self, epoch):
        from ..eval import compute_fvd, init_fvd_backbone

        if not hasattr(self, "_fvd_net"):
            self._fvd_net = init_fvd_backbone(self.device)
        T = self.config["data"]["max_frames"]
        reals, fakes = [], []
        for batch in self.val_batches(epoch):
            fakes.append(self.model.forward_sample(batch, T, self.generator).cpu())
            reals.append(batch["images"][:, 1:].cpu())
        n = sum(r.shape[0] for r in reals)
        return {"FVD-val": float(compute_fvd(self._fvd_net, torch.cat(reals),
                                             torch.cat(fakes), batch_size=min(8, n)))}


class INNFCAEExperiment(Experiment):
    """An unconditioned flat INN density model over the frozen BigAE flow
    encoder's posterior samples (reference ``FCAEINNModel``): NLL, AMSGrad
    on the warmup / linear-decay schedule, no DDI; monitored on the
    validation NLL."""

    monitor = "flow_loss-val"
    datakeys = ["flow"]

    def build(self):
        from ..core.optim import flow_adam
        from ..flows import ParamTree
        from ..flows.fc import build_unsupervised_transformer3
        from ..models.fc_stack import build_big_ae
        from ..train import run_lr_schedule

        cfg = self.config
        self.flow_encoder = load_frozen_net(cfg, "flow_encoder", build_big_ae,
                                            self.init_generator).to(self.device)
        arch = dict(cfg["architecture"])
        arch.setdefault("flow_in_channels", self.flow_encoder.z_dim)
        arch.setdefault("flow_mid_channels", 4 * arch["flow_in_channels"])
        self.inn = build_unsupervised_transformer3(arch)
        self.inn_params = ParamTree({"inn": self.inn.init(self.init_generator, "cpu")})
        self.inn_params.to(self.device)
        self.tx = self.accumulate(flow_adam(self.inn_params.trainable(),
                                            run_lr_schedule(cfg["training"])))

    def encode(self, batch):
        """A posterior sample of the flow encoder, without grad."""
        with torch.no_grad():
            mu, logvar = self.flow_encoder.encode(batch["flow"])
            return mu + torch.exp(0.5 * logvar) * torch.randn(
                mu.shape, generator=self.generator, device=mu.device)

    def loss(self, batch):
        from ..flows import flow_loss

        z, logdet = self.inn.forward(self.inn_params.tree()["inn"], self.encode(batch))
        return flow_loss(z, logdet, generator=self.generator)

    def train_step(self, batch, epoch):
        loss, log = self.loss(batch)
        loss.backward()
        self.tx.step()
        return {k: v.detach() for k, v in log.items()}

    def checkpoint_state(self):
        return {"inn": self.inn_params.state_dict(), "tx": self.tx.state_dict()}

    def load_checkpoint_state(self, state):
        self.inn_params.load_state_dict(state["inn"])
        self.tx.load_state_dict(state["tx"])

    def export_weights(self):
        return self.inn_params.state_dict()

    @torch.no_grad()
    def validate(self, epoch):
        losses = [float(self.loss(batch)[0]) for batch in self.val_batches(epoch)]
        return {"flow_loss-val": float(np.mean(losses))}


def load_flow_encoder(config, generator):
    """The frozen flow encoder of ``config["flow_encoder"]``: the port's
    BigAE of a ``flow_encoder_fc`` run (``load_frozen_net``), or with
    ``torch_compat_npz`` the reference FCAE (``models/biggan_compat.py``)
    at ``type`` (resnet101) and ``n_in_channels`` (2)."""
    from ..models.fc_stack import build_big_ae

    sec = config["flow_encoder"]
    if sec.get("torch_compat_npz"):
        from ..models.biggan_compat import load_torch_bigae_npz

        return load_torch_bigae_npz(sec["torch_compat_npz"], int(sec["z_dim"]),
                                    sec.get("type", "resnet101"),
                                    int(sec.get("n_in_channels", 2)))
    return load_frozen_net(config, "flow_encoder", build_big_ae, generator)


class FlowVAEExperiment(Experiment):
    """Trainer for the conv ``ConvFlowVAE`` (reference FlowVAE/FlowVAE3,
    models/opticalFlow/models.py), the frozen flow encoder of
    ``flow_motion``: MSE recon + KL, monitored on the recon endpoint
    error."""

    monitor = "EE-val"
    datakeys = ["flow"]

    def build(self):
        from ..train import FlowVAETrainer

        cfg = self.config
        arch = cfg["architecture"]
        self.model = entry.build_flow_vae(
            cfg["data"]["spatial_size"][0], arch, arch.get("min_spatial_size", 8),
            "cpu", self.init_generator).to(self.device)
        self.trainer = FlowVAETrainer(cfg, self.model, wrap=self.accumulate)
        self.tx = self.trainer.tx

    def train_step(self, batch, epoch):
        return self.trainer.train_step(batch, self.generator)

    def checkpoint_state(self):
        return {"model": self.model.state_dict(), "tx": self.tx.state_dict()}

    def load_checkpoint_state(self, state):
        self.model.load_state_dict(state["model"])
        self.tx.load_state_dict(state["tx"])

    def export_weights(self):
        return self.model.state_dict()

    def validate(self, epoch):
        return self.trainer.validate(self.val_batches(epoch))


class FlowMotionExperiment(Experiment):
    """Conv third stage (reference ``opticalFlowINN.py`` / ``flow_motion.py``):
    the bridge INN trained against the frozen conv second stage (its
    ``*_weights``, fp32) and flow VAE (``flow_vae.ckpt``'s, else random),
    over the frozen nets of ``load_frozen``; monitored on the endpoint
    error of hallucinated flow."""

    monitor = "EE-val"
    datakeys = ["images", "poke", "flow"]

    def build(self):
        from ..flows import ParamTree
        from ..models.second_stage import SecondStageModel
        from ..models.third_stage import FlowMotionModel
        from ..train import FlowMotionTrainer

        cfg, gen = self.config, self.init_generator
        first, cond, poke = load_frozen(cfg, gen)
        ss_sec = cfg["second_stage"]
        ss_cfg = load_config(ss_sec["config"]) if isinstance(
            ss_sec.get("config"), str) else Config(ss_sec["config"])
        ss_model = SecondStageModel(ss_cfg, first, cond, poke)
        ss_model.flow_params = ParamTree(ss_model.init_params(gen, "cpu"))
        if ss_sec.get("ckpt"):
            ss_model.flow_params.load_state_dict(CheckpointStore(
                ss_sec["ckpt"]).restore_best(weights=True))

        arch = cfg["architecture"]
        vae = entry.build_flow_vae(cfg["data"]["spatial_size"][0], arch,
                                   ss_model.min_spatial_size, "cpu", gen)
        fv_sec = cfg.get("flow_vae", {}) or {}
        if fv_sec.get("ckpt"):
            vae.load_state_dict(CheckpointStore(fv_sec["ckpt"]).restore_best(
                weights=True))
        self.model = FlowMotionModel(cfg, ss_model, vae)
        self.model.inn_params = ParamTree(self.model.init(gen, "cpu"))
        self.model.to(self.device).eval()
        self.trainer = FlowMotionTrainer(self.model, wrap=self.accumulate)

    @property
    def tx(self):
        return self.trainer.state.tx

    def train_step(self, batch, epoch):
        return self.trainer.train_step(batch, epoch, self.generator)

    def checkpoint_state(self):
        return {"inn": self.model.inn_params.state_dict(),
                "tx": self.tx.state_dict(),
                "updates": self.trainer.state.step}

    def load_checkpoint_state(self, state):
        import dataclasses

        self.model.inn_params.load_state_dict(state["inn"])
        self.tx.load_state_dict(state["tx"])
        self.trainer.state = dataclasses.replace(self.trainer.state,
                                                 step=int(state["updates"]))

    def export_weights(self):
        return self.model.inn_params.state_dict()

    @torch.no_grad()
    def validate(self, epoch):
        return self.trainer.validate(self.val_batches(epoch), self.generator)


class ThirdStageFCExperiment(FlowMotionExperiment):
    """The fork's namesake third stage (reference
    ``experiments/third_stage_video_fc.py``): an unconditioned (or, with
    ``general.conditional``, poke-conditioned) flat coupling INN aligns the
    frozen flow encoder's latents with the frozen FC second stage's
    residual; fp32, AMSGrad on the warmup / linear-decay schedule, the
    recon-weight doubling under ``recon_scaling``, no DDI.  Monitored on
    ``EE_R3-val``: the share of flow vectors more than 3 px off between
    the residual-seeded hallucinated flow and the flow encoder's
    reconstruction of the real flow.  Steps, checkpoints and validation
    are ``FlowMotionExperiment``'s over its trainer."""

    monitor = "EE_R3-val"
    # the --test realism and third-stage accuracy modes (cli/testing.py)
    evaluates_hallucinated_flow = True

    def build(self):
        from ..flows import ParamTree
        from ..models.fc_baseline import SecondStageModelFC
        from ..models.third_stage import ThirdStageFC
        from ..train import ThirdStageFCTrainer

        cfg, gen = self.config, self.init_generator
        # the frozen FC second stage: its frozen nets from this config's
        # sections, its flat cINN as second_stage.config builds it, with the
        # best *_weights of the second_stage.ckpt run (random without one)
        ss_sec = cfg["second_stage"]
        ss_cfg = load_config(ss_sec["config"]) if isinstance(
            ss_sec.get("config"), str) else Config(ss_sec["config"])
        self.ss_model = SecondStageModelFC(ss_cfg, *load_frozen_fc(cfg, gen))
        self.ss_model.flow_params = ParamTree(self.ss_model.flow.init(gen, "cpu"))
        if ss_sec.get("ckpt"):
            self.ss_model.flow_params.load_state_dict(CheckpointStore(
                ss_sec["ckpt"]).restore_best(weights=True))
        self.ss_model.eval().requires_grad_(False)
        self.flow_encoder = load_flow_encoder(cfg, gen)
        # the INN's dims default to the second stage's residual's
        cfg["architecture"] = dict(cfg["architecture"])
        cfg["architecture"].setdefault("flow_in_channels", self.ss_model.flow_in_channels)
        conditional = bool(cfg.get("general", {}).get("conditional", False))
        self.model = ThirdStageFC(cfg, self.flow_encoder, self.ss_model,
                                  self.ss_model.poke_embedder.nf_max if conditional else 0)
        self.model.inn_params = ParamTree(self.model.init(gen, "cpu"))
        self.model.to(self.device).eval()
        self.trainer = ThirdStageFCTrainer(self.model, wrap=self.accumulate)

    @torch.no_grad()
    def sample_video(self, batch, length: int):
        """The composed fork capability: measured flow -> flow-encoder
        latent -> INN -> second-stage residual -> motion latent -> video
        (B, T, H, W, 3), with no ground-truth poke in the motion; the FC
        first stage's decode runs K3 once a level."""
        return self.model.forward_video_from_flow(batch, length, self.generator)
