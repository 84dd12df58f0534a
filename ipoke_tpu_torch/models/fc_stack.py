"""The FC tower's BigAE VAE-GAN step (counterpart of
``ipoke_tpu/models/fc_stack.py``): the flow encoder of ``flow_encoder_fc``
on 2-channel flow maps, or the image BigAE on 3-channel frames.

``FCAEStep`` runs the JAX package's ``make_fcae_train_step`` in its order:

1. one forward with the posterior noise given (the JAX step's two applies
   share their key, so both heads see the same reconstruction): the NLL
   head L1 + perc_weight * VGG + kl_weight * KL and its gradient, and the
   adversarial head -mean(D(rec)) with the discriminator in eval and its
   gradient;
2. the GAN weight ||grad nll|| / (||grad adv|| + 1e-4) over the BigAE's
   leaves, clipped to [0, 1e4], times ``disc_weight``, relu(1 -
   relu(previous d_loss)) and ``disc_factor``; the generator's update;
3. the hinge discriminator loss (times ``disc_factor``) on the real batch
   in train mode (its spectral norms store their new u) and the
   reconstruction in eval, and its update only where that loss is above 0
   (``core.optim.gated_update``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.optim import gated_update
from ..nn.discriminators import hinge_d_loss
from ..nn.vgg import vgg_loss
from .big_ae import BigAE, gaussian_kl
from .image_ae import _leaf_norm, pad3


def build_big_ae(config) -> BigAE:
    arch = config["architecture"]
    return BigAE(z_dim=arch["z_dim"], spatial_size=config["data"]["spatial_size"][0],
                 in_channels=arch.get("n_out_channels", 2),
                 gen_ch=arch.get("gen_ch", 48))


def fcae_key(config) -> str:
    """The batch key the BigAE trains on: flow maps at 2 channels, else the
    clip's first frame."""
    return "flow" if config["architecture"].get("n_out_channels", 2) == 2 else "images"


def fcae_input(batch, key: str):
    x = batch[key]
    return x[:, 0] if key == "images" and x.dim() == 5 else x


class FCAEStep:
    """``step(batch, disc_factor, noise) -> metrics`` (see the module
    docstring); ``noise`` (B, z_dim) is the posterior's standard normal
    draw.  Keeps the previous discriminator loss between steps
    (``prev_d_loss``, part of the train state)."""

    def __init__(self, config, model: BigAE, disc, vgg, tx, tx_d):
        tcfg = config["training"]
        self.model, self.disc, self.vgg, self.tx, self.tx_d = model, disc, vgg, tx, tx_d
        self.perc_w = float(tcfg.get("perc_weight", 1.0))
        self.kl_w = float(tcfg.get("kl_weight", 1e-6))
        self.disc_weight = float(tcfg.get("disc_weight", 1.0))
        self.key = fcae_key(config)
        self.prev_d_loss = torch.zeros(())
        for p in vgg.parameters():
            p.requires_grad_(False)

    def __call__(self, batch, disc_factor: float, noise: torch.Tensor):
        x = fcae_input(batch, self.key)
        params = self.tx.params
        rec, mu, logvar = self.model(x, noise)
        vx, vr = (x, rec) if x.shape[-1] == 3 else (pad3(x), pad3(rec))
        rec_loss = (x - rec).abs().mean()
        p_loss = vgg_loss(self.vgg, vx, vr)
        kl = gaussian_kl(mu, logvar)
        nll = rec_loss + self.perc_w * p_loss + self.kl_w * kl
        zeros = lambda gs: [torch.zeros_like(p) if g is None else g
                            for p, g in zip(params, gs)]
        g_nll = zeros(torch.autograd.grad(nll, params, retain_graph=True,
                                          allow_unused=True))
        g_adv_val = -self.disc(rec, train=False)[0].mean()
        g_adv = zeros(torch.autograd.grad(g_adv_val, params, allow_unused=True))
        prev = self.prev_d_loss.to(x.device)
        d_weight = (torch.clamp(_leaf_norm(g_nll) / (_leaf_norm(g_adv) + 1e-4), 0.0, 1e4)
                    * self.disc_weight * torch.relu(1.0 - torch.relu(prev)) * disc_factor)
        for p, a, b in zip(params, g_nll, g_adv):
            p.grad = a + d_weight * b
        self.tx.step()

        rec = rec.detach()
        lf = self.disc(rec, train=False)[0]  # the old u, as JAX's fake pass
        lr = self.disc(x, train=True)[0]
        d_loss = disc_factor * 0.5 * (hinge_d_loss(lr, True) + hinge_d_loss(lf, False))
        grads = torch.autograd.grad(d_loss, self.tx_d.params, allow_unused=True)
        for p, g in zip(self.tx_d.params, grads):
            p.grad = g
        gated_update(self.tx_d, d_loss.detach() > 0)
        self.prev_d_loss = d_loss.detach()
        return {"rec_loss": rec_loss.detach(), "p_loss": p_loss.detach(),
                "kl_loss": kl.detach(), "g_loss": g_adv_val.detach(),
                "d_loss": self.prev_d_loss, "d_weight": d_weight.detach(),
                "logits_real": lr.detach().mean(), "logits_fake": lf.detach().mean()}


class FCAETrainer:
    """``FlowEncoderFCExperiment``'s step: the discriminator's factor 1
    from epoch ``disc.start`` on, the posterior noise drawn from the
    caller's generator (or given)."""

    def __init__(self, config, model, disc, vgg, tx, tx_d):
        self.step = FCAEStep(config, model, disc, vgg, tx, tx_d)
        self.disc_start = int(config.get("disc", {}).get("start", 0))
        self.z_dim = model.z_dim

    def train_step(self, batch, epoch: int, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None):
        x = batch[self.step.key]
        if noise is None:
            noise = torch.randn((x.shape[0], self.z_dim), generator=generator,
                                device=x.device, dtype=x.dtype)
        return self.step(batch, 1.0 if epoch >= self.disc_start else 0.0, noise)
