"""Image / poke encoder stages (counterpart of ``ipoke_tpu/models/image_ae.py``).

* The conditioner phi(x_0): a conv AE (``FirstStageWrapper`` with its
  decoder and flax's spectral norm) trained as a VAE-GAN with a learned
  output ``logvar`` and an adaptive discriminator weight (reference
  ``models/first_stage_image_conv.py:21-200``).
* The poke embedder phi(c): the same AE on the 2-channel poke, target the
  full flow map, NLL only, no discriminator (reference
  ``models/conv_poke_encoder.py:16-120``).

``ImageAEStep`` runs the JAX package's ``make_image_ae_train_step`` in its
order: the discriminator's update on a reconstruction made without grad in
eval mode, then the AE's update from one train-mode forward (which stores
each spectral norm's new u) whose reconstruction feeds both the NLL and the
discriminator, with its new params and u in eval mode.  The weight of the
GAN term is ||grad nll|| / (||grad adv|| + 1e-4) over the AE's leaves,
clipped to [0, 1e4], times ``disc_weight`` and the gate.  With
``disc_gate`` 0 the discriminator's step is skipped (its u still
advances), as ``gated_update`` keeps it in JAX.

A variational AE (``architecture.deterministic: false``) reconstructs from
its sample mean + exp(logstd) * eps, one eps a step for all three forwards
(the JAX step's one rng), given as ``noise`` or drawn from the step's
generator.  The JAX step reads ``training.w_kl`` but adds no KL term, and
neither does this one.  ``poke_and_image``: the AE's input is the poke (or
flow) with the clip's first frame appended on the channel axis.

``freeze_spectral_norm`` turns a trained net into the frozen one that the
second stage runs: each spectral norm collapsed into its weight by flax's
eval rule.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..nn.blocks import SpectralNormed
from ..nn.discriminators import PatchDiscriminator2D, gradient_penalty, hinge_d_loss
from ..nn.encoders import FirstStageWrapper
from ..nn.vgg import vgg_loss


class ImageAE(nn.Module):
    """The trained tree of the JAX package's ``{'ae': ..., 'logvar': ()}``."""

    def __init__(self, ae: FirstStageWrapper):
        super().__init__()
        self.ae = ae
        self.logvar = nn.Parameter(torch.zeros(()))


def build_image_ae(config) -> ImageAE:
    arch = config["architecture"]
    return ImageAE(FirstStageWrapper(
        config["data"]["spatial_size"][0], nf_in=arch.get("nf_in", 3),
        nf_max=arch["nf_max"], min_spatial_size=arch.get("min_spatial_size", 8),
        decoder=True, deterministic=arch.get("deterministic", True),
        poke_and_image=arch.get("poke_and_image", False)))


def build_image_disc(config) -> PatchDiscriminator2D:
    dcfg = config.get("disc", {})
    return PatchDiscriminator2D(ndf=dcfg.get("ndf", 64),
                                n_layers=dcfg.get("n_layers", 3))


def pad3(x):
    """A 2-channel flow map padded to 3 channels for VGG (reference
    conv_poke_encoder.py:72-74)."""
    return torch.cat([x, x.new_zeros((*x.shape[:-1], 1))], dim=-1)


def nll_recon_loss(x, rec, logvar, vgg, perc_weight: float = 1.0):
    """(sum((|x - rec| + w * p_loss) / exp(logvar) + logvar) / B, p_loss)."""
    rec_map = (x - rec).abs()
    vx, vr = (x, rec) if x.shape[-1] == 3 else (pad3(x), pad3(rec))
    p_loss = vgg_loss(vgg, vx, vr)
    rec_map = rec_map + perc_weight * p_loss
    nll = rec_map / torch.exp(logvar) + logvar
    return nll.sum() / x.shape[0], p_loss


def kl_conv(mu, logstd):
    """Reference ``utils/losses.py:50-56`` (takes log-std)."""
    mu = mu.reshape(mu.shape[0], -1)
    logvar = 2.0 * logstd.reshape(logstd.shape[0], -1)
    return torch.mean(0.5 * torch.sum(mu ** 2 + torch.exp(logvar) - 1.0 - logvar,
                                      dim=-1))


def _leaf_norm(grads):
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads) + 1e-12)


def create_image_ae_state(model: ImageAE, disc, make_tx: Callable,
                          use_disc: bool = True):
    """(tx, tx_d): ``make_tx(params)`` over the AE's params then ``logvar``
    (``ImageAEStep`` relies on that order), and over the discriminator's
    (None without one)."""
    tx = make_tx([*model.ae.parameters(), model.logvar])
    tx_d = make_tx(list(disc.parameters())) if use_disc else None
    return tx, tx_d


class ImageAEStep:
    """``step(batch, disc_gate) -> metrics`` (see the module docstring)."""

    def __init__(self, config, model: ImageAE, disc, vgg, tx, tx_d,
                 use_disc: bool = True):
        tcfg = config["training"]
        self.model, self.disc, self.vgg = model, disc, vgg
        self.tx, self.tx_d, self.use_disc = tx, tx_d, use_disc
        self.perc_w = tcfg.get("perc_weight", 1.0)
        self.disc_weight = tcfg.get("disc_weight", 1.0)
        self.gp_weight = config.get("disc", {}).get("gp_weight", 0.0)
        self.input_key = config.get("input_key", "images")
        self.target_key = config.get("target_key", "images")
        self.n_ae = len(list(model.ae.parameters()))
        for p in vgg.parameters():
            p.requires_grad_(False)

    def io(self, batch):
        """(input, target): the last frame of a clip for ``images``; with
        ``poke_and_image`` the input has the clip's first frame appended."""
        x_in, tgt = batch[self.input_key], batch[self.target_key]
        if self.input_key == "images" and x_in.dim() == 5:
            x_in = x_in[:, -1]
        if self.model.ae.poke_and_image:
            x_in = torch.cat([x_in, batch["images"][:, 0]], dim=-1)
        if self.target_key == "images" and tgt.dim() == 5:
            tgt = tgt[:, -1]
        return x_in, tgt

    def noise(self, x_in, generator=None):
        """eps for a variational AE's sample: N(0, 1) of one latent per item,
        drawn from ``generator`` (None without one, or when deterministic)."""
        ae = self.model.ae
        if ae.deterministic or generator is None:
            return None
        return torch.randn((x_in.shape[0], *ae.latent_shape), generator=generator,
                           device=x_in.device, dtype=x_in.dtype)

    def update_disc(self, x_in, target, disc_gate, noise=None):
        d = self.disc
        with torch.no_grad():
            rec0 = self.model.ae(x_in, train=False, noise=noise)
        pred_true = d(target, train=False)[0]
        gp = target.new_zeros(())
        if self.gp_weight > 0:
            gp = gradient_penalty(lambda v: d(v, train=False)[0], target).mean()
        pred_fake = d(rec0, train=True)[0]
        loss = 0.5 * (hinge_d_loss(pred_fake, False) + hinge_d_loss(pred_true, True))
        if disc_gate > 0:
            grads = torch.autograd.grad(disc_gate * (loss + self.gp_weight * gp),
                                        self.tx_d.params, allow_unused=True)
            for p, g in zip(self.tx_d.params, grads):
                p.grad = g
            self.tx_d.step()
        return loss.detach()

    def __call__(self, batch, disc_gate: float, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """One step; a variational AE's eps is ``noise`` or drawn from
        ``generator`` (the mean without either)."""
        x_in, target = self.io(batch)
        if noise is None:
            noise = self.noise(x_in, generator)
        loss_d = self.update_disc(x_in, target, disc_gate, noise) if self.use_disc \
            else target.new_zeros(())
        params = self.tx.params
        logvar = self.model.logvar.detach().clone()
        rec = self.model.ae(x_in, train=True, noise=noise)
        nll, p_loss = nll_recon_loss(target, rec, self.model.logvar, self.vgg,
                                     self.perc_w)
        zeros = lambda gs: [torch.zeros_like(p) if g is None else g
                            for p, g in zip(params, gs)]
        g_nll = zeros(torch.autograd.grad(nll, params, allow_unused=True,
                                          retain_graph=self.use_disc))
        adv = d_weight = target.new_zeros(())
        grads = g_nll
        if self.use_disc:
            adv = -self.disc(rec, train=False)[0].mean()
            g_adv = zeros(torch.autograd.grad(adv, params, allow_unused=True))
            ratio = _leaf_norm(g_nll[:self.n_ae]) / (_leaf_norm(g_adv[:self.n_ae])
                                                     + 1e-4)
            d_weight = torch.clamp(ratio, 0.0, 1e4) * self.disc_weight * disc_gate
            grads = [a + d_weight * b for a, b in zip(g_nll, g_adv)]
        for p, g in zip(params, grads):
            p.grad = g
        self.tx.step()
        return {"nll_loss": nll.detach(), "p_loss": p_loss.detach(),
                "g_loss": adv.detach(), "d_loss": loss_d,
                "d_weight": d_weight.detach(), "logvar": logvar}


def make_image_ae_train_step(config, model, disc, vgg, tx, tx_d,
                             use_disc: bool = True) -> ImageAEStep:
    return ImageAEStep(config, model, disc, vgg, tx, tx_d, use_disc)


@torch.no_grad()
def freeze_spectral_norm(module: nn.Module) -> nn.Module:
    """Collapse every live spectral norm of ``module`` into its weight (one
    power-iteration step from the stored u, W / sigma: flax's eval rule,
    ``convert.collapse_spectral_norm``) and drop its u and sigma, in place."""
    for sub in module.modules():
        if isinstance(sub, SpectralNormed) and sub.snorm:
            w = sub.normed_weight(train=False)
            sub.weight.copy_(w)
            sub.snorm = False
            del sub._buffers["u"], sub._buffers["sigma"]
    return module
