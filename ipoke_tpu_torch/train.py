"""The trainers' sequences (counterpart of ``ipoke_tpu/cli/experiments.py``,
``build`` and ``train_step`` of the first and second stage).

First stage (``FirstStageTrainer``): three ``gan_adam`` optimizers on the
staircase schedule (per optimizer, at the updates it has made), the
discriminators gated on ``epoch >= d_t.pretrain``, the KL weight annealed
over ``kl_annealing`` epochs, one step's random numbers drawn from the
caller's generator (``sample_draws``).

Every trainer takes ``wrap``, applied to each optimizer it builds: the
experiment layer's grad accumulation (``core.optim.with_grad_accumulation``).
The experiments (``cli/experiments.py``) add data, validation and
checkpoints.

Second stage (``SecondStageTrainer``):

1. data-dependent init of the flow in fp32 on the first batch (``ddi``);
2. under the mixed recipe, params and frozen nets cast to bf16 (``start``);
3. the optimizer built then, so that its fp32 masters copy the post-DDI,
   bf16-rounded values;
4. every step casts the batch to bf16 (``make_second_stage_train_step``).

The caller runs 1 (``ddi``) and 2-3 (``start``) before the first
``train_step``, and may change the params between them (``entry.perturb``
in tests).

Conv third stage (counterpart of ``ipoke_tpu/cli/fc_experiments.py``):
``FlowVAETrainer`` trains the ``ConvFlowVAE`` (MSE + kl_weight * KL, plain
Adam, every spectral norm's u advancing each step); ``FlowMotionTrainer``
trains the bridge INN over the frozen second stage and flow VAE
(``flow_adam`` on the warmup/linear-decay schedule, the recon-weight
doubling).  Both ``validate`` on endpoint and angular error.  No DDI runs,
as in the JAX trainer.  ``ThirdStageFCTrainer`` is the bridge trainer over
the FC third stage's flat INN (MSE to the residual), validated on its NLL,
its recon error and the flow-error categories of residual-seeded flow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.optim import (
    adam,
    cast_floats,
    exp_decay_per_epoch,
    flow_adam,
    gan_adam,
    master_weights,
    warmup_linear_decay,
)
from .eval import angular_error, endpoint_error, optical_flow_metrics
from .flows import flow_loss
from .models.first_stage import (
    FirstStageStep,
    create_first_stage_state,
    kl_loss,
    sample_draws,
)
from .models.second_stage import (
    SecondStageModel,
    create_second_stage_state,
    make_second_stage_train_step,
)
from .models.third_stage import (
    ConvFlowVAE,
    FlowMotionModel,
    create_third_stage_state,
    double_recon_weight_schedule,
    make_flow_motion_train_step,
    make_third_stage_fc_train_step,
)


def _identity(tx):
    return tx


def run_lr_schedule(tcfg, decay_to_end: bool = True):
    """The second stage's and the bridge's schedule from the training
    config: warmup over ``lr_scaling_max_it``, then linear decay to 0 at the
    run's last step, ``n_epochs * max_batches_per_epoch`` (the experiment
    writes its ``--debug`` values there), or at 10**9 without
    ``decay_to_end`` (``custom_lr_decrease`` off)."""
    total = int(tcfg.get("n_epochs", 100)) * int(
        tcfg.get("max_batches_per_epoch", 10**9)) if decay_to_end else 10**9
    return warmup_linear_decay(float(tcfg.get("lr", 1e-3)),
                               int(tcfg.get("lr_scaling_max_it", 500)), total)


class SecondStageTrainer:
    """``clip_grad_norm``: ``flow_adam``'s clip by global norm (0: none)."""

    def __init__(self, model: SecondStageModel, lr_schedule,
                 clip_grad_norm: float = 0.0, wrap=_identity):
        self.model = model
        self.mixed = bool(model.config.get("training", {}).get(
            "mixed_prec_master", False))
        self.make_tx = lambda params: flow_adam(params, lr_schedule, clip_grad_norm)
        self.wrap = wrap
        self.tx = self._step = None

    def ddi(self, batch, generator: Optional[torch.Generator] = None) -> None:
        """fp32 data-dependent init on ``batch``, into the flow params."""
        new = self.model.ddi(cast_floats(batch, torch.float32), generator)
        self.model.flow_params.load_tree(new)

    def start(self) -> None:
        """Cast to bf16 under the mixed recipe, then build the optimizer."""
        if self.mixed:
            self.model.to(torch.bfloat16)
            make = lambda params: master_weights(params, self.make_tx)
        else:
            make = self.make_tx
        self.tx = self.wrap(create_second_stage_state(self.model, make))
        self._step = make_second_stage_train_step(self.model, self.tx)

    def train_step(self, batch, generator: Optional[torch.Generator] = None):
        if self.tx is None:
            raise RuntimeError("SecondStageTrainer.train_step before start()")
        return self._step(batch, generator)


class FirstStageTrainer:
    def __init__(self, config, model, disc_s, disc_t, vgg, wrap=_identity):
        tcfg = config["training"]
        self.config = config
        steps = int(tcfg.get("max_batches_per_epoch", 10 ** 9))
        sched = exp_decay_per_epoch(float(tcfg.get("lr", 2e-4)),
                                    float(tcfg.get("gamma", 0.98)), steps)
        wd = float(tcfg.get("weight_decay", 1e-5))
        self.tx = create_first_stage_state(
            model, disc_s, disc_t, lambda params: wrap(gan_adam(params, sched, wd)))
        self.step = FirstStageStep(config, model, disc_s, disc_t, vgg, *self.tx)
        self.pretrain = int(config["d_t"].get("pretrain", 0))
        self.anneal = float(tcfg.get("kl_annealing", 0))

    def gates(self, epoch: int):
        """(disc_gate, kl_gate) at ``epoch``."""
        kl_gate = min(1.0, (epoch + 1) / self.anneal) if self.anneal > 0 else 1.0
        return (1.0 if epoch >= self.pretrain else 0.0), kl_gate

    def train_step(self, batch, epoch: int, generator: torch.Generator):
        draws = sample_draws(generator, self.config, batch["images"].shape[0])
        draws = {k: v.to(batch["images"].device) if torch.is_tensor(v) else v
                 for k, v in draws.items()}
        return self.step(batch, draws, *self.gates(epoch))


def _flow_errors(pairs):
    """{"EE-val", "AE-val"}: the mean endpoint and angular errors over
    (flow, estimate) pairs, each pair's mean first."""
    ees, aes = [], []
    for flow, est in pairs:
        ees.append(endpoint_error(flow, est).mean().item())
        aes.append(angular_error(flow, est).mean().item())
    return {"EE-val": sum(ees) / len(ees), "AE-val": sum(aes) / len(aes)}


class FlowVAETrainer:
    """``FlowVAEExperiment``'s step: ``optax.adam(lr)``, loss MSE(rec, flow)
    + kl_weight * KL (channel-sum, mean elsewhere), the encoder's sample
    drawn from the caller's generator or given as ``noise``."""

    def __init__(self, config, model: ConvFlowVAE, wrap=_identity):
        tcfg = config["training"]
        self.model = model.requires_grad_(True)
        self.kl_weight = float(tcfg.get("kl_weight", 1e-6))
        self.tx = wrap(adam(list(model.parameters()), float(tcfg.get("lr", 1e-3))))

    def train_step(self, batch, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None):
        flow = batch["flow"]
        rec, mu, logvar = self.model(flow, generator, noise, train=True)
        rec_l = torch.mean((rec - flow) ** 2)
        kl = kl_loss(mu, logvar)
        loss = rec_l + self.kl_weight * kl
        loss.backward()
        self.tx.step()
        return {"loss": loss.detach(), "rec_loss": rec_l.detach(),
                "kl_loss": kl.detach()}

    @torch.no_grad()
    def validate(self, batches):
        """Endpoint and angular error of the reconstruction (z = mu)."""
        return _flow_errors((b["flow"], self.model(b["flow"])[0]) for b in batches)


class FlowMotionTrainer:
    """``FlowMotionExperiment``'s build and step: ``flow_adam`` over the
    bridge's params only, on ``lr_schedule`` (default: the config's,
    ``run_lr_schedule``), and with ``recon_scaling`` the recon weight
    doubled every 10 epochs."""

    make_step = staticmethod(make_flow_motion_train_step)

    def __init__(self, model: FlowMotionModel, lr_schedule=None, wrap=_identity):
        tcfg = model.config["training"]
        if lr_schedule is None:
            lr_schedule = run_lr_schedule(tcfg)
        self.model = model
        self.weight_recon = float(tcfg.get("weight_recon", 1.0))
        self.recon_scaling = bool(tcfg.get("recon_scaling", False))
        self.state = create_third_stage_state(
            model, lambda params: wrap(flow_adam(params, lr_schedule)),
            self.weight_recon)
        self._step = self.make_step(model)

    def train_step(self, batch, epoch: int,
                   generator: Optional[torch.Generator] = None, noise=None):
        if self.recon_scaling:
            self.state = double_recon_weight_schedule(self.state, epoch,
                                                      self.weight_recon)
        self.state, log = self._step(self.state, batch, generator, noise)
        return log

    def validate(self, batches, generator: Optional[torch.Generator] = None):
        """Endpoint and angular error of hallucinated flow against the
        batch's flow."""
        return _flow_errors((b["flow"], self.model.forward_sample_flow(b, generator))
                            for b in batches)


class ThirdStageFCTrainer(FlowMotionTrainer):
    """``ThirdStageFCExperiment``'s build and step: ``FlowMotionTrainer``'s
    optimizer, schedule and recon weight over the FC third stage's INN."""

    make_step = staticmethod(make_third_stage_fc_train_step)

    @torch.no_grad()
    def validate(self, batches, generator: Optional[torch.Generator] = None):
        """Per batch, then averaged (``<name>-val``): the INN's flow loss and
        recon error against the second stage's residual, and the flow-error
        categories of the residual-seeded hallucinated flow against the
        flow encoder's reconstruction of the batch's flow (mu decoded)."""
        model, agg = self.model, {}
        for b in batches:
            h = model.condition(b)
            target = model.second_stage_density(b, generator)
            out, logdet = model.forward_density(b, generator, h=h)
            m = optical_flow_metrics(
                model.forward_sample_flow(b, generator, h, z=target.reshape(out.shape))[0],
                model.decode_flow_latent(model.encode_flow(b["flow"])[0]))
            m["flow_loss"] = flow_loss(out, logdet)[0]
            m["reconstruction_loss"] = torch.mean((out - target.reshape(out.shape)) ** 2)
            for k, v in m.items():
                agg.setdefault(k, []).append(float(v))
        return {f"{k}-val": float(np.mean(v)) for k, v in agg.items()}
