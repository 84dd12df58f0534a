"""The fork's conv third-stage experiments (counterpart of
``ipoke_tpu/cli/fc_experiments.py``'s ``FlowVAEExperiment`` and
``FlowMotionExperiment``), over ``train.FlowVAETrainer`` and
``train.FlowMotionTrainer``.  The FC experiments are not ported (ROADMAP
queue 1 item 8)."""

from __future__ import annotations

import torch

from .. import entry
from ..core.checkpoint import CheckpointStore
from ..core.config import Config, load_config
from .experiments import Experiment, load_frozen


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
        ss_model.flow_params = ParamTree(ss_model.flow.init(gen, "cpu"))
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
