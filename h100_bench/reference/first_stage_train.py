"""Plain reference of the first stage's VAE-GAN step
(``FirstStageTrainer.train_step`` -> ``FirstStageStep``), fp32 with TF32
off: the generator forward, the temporal discriminator's update (hinge and
the R1 penalty on a window), the spatial discriminator's (hinge on sampled
frames), then the generator's (hinge of both, feature matching, VGG19, L1,
KL), each net by Adam with betas (0.5, 0.9) and coupled weight decay.
Imports nothing of the port.

The step's random numbers are the benchmark's: ``sample_draws`` draws them
from a generator in the order the program's step draws them, so both sides
take the same noise, window and frames.
"""

from __future__ import annotations

import torch
from torch import nn

from .gan import (PatchDiscriminator2D, ResNet3DDiscriminator, VGG19Features, fmap_loss,
                  gen_loss, gradient_penalty, hinge_d_loss, kl_loss, vgg_loss)
from .nets import FirstStageModel, specs

NETS = ("model", "disc_s", "disc_t")  # the nets that train, in the step's order of tx
BETAS, EPS = (0.5, 0.9), 1e-8


class FirstStageNets(nn.Module):
    """``cfg``: the configuration's ``model`` block (``config/first_stage.yaml``'s
    tree)."""

    def __init__(self, cfg):
        super().__init__()
        arch, data = cfg["architecture"], cfg["data"]
        self.model = FirstStageModel(
            data["spatial_size"][0], arch["z_dim"], tuple(arch["dec_channels"]),
            arch["n_gru_layers"], arch["min_spatial_size"], tuple(arch["ENC_M_channels"]),
            data["max_frames"], spectral_norm=arch["spectral_norm"])
        self.disc_s = PatchDiscriminator2D(cfg["d_s"]["ndf"], cfg["d_s"]["n_layers"])
        self.disc_t = ResNet3DDiscriminator(tuple(cfg["d_t"]["layers"]))
        self.vgg = VGG19Features()

    def specs(self):
        return specs(self)


def build(cfg) -> FirstStageNets:
    with torch.device("meta"):
        return FirstStageNets(cfg)


def window_frames(cfg) -> int:
    return min(cfg["d_t"].get("max_frames", 8), cfg["data"]["max_frames"] + 1)


def sample_draws(generator, cfg, batch_size):
    """One step's draws, in the program's order: the encoder noise, the d_t
    window's start, d_s's real and fake frame indices."""
    t, n_ex = cfg["data"]["max_frames"], cfg["d_s"].get("n_examples", 16)
    s = cfg["architecture"]["min_spatial_size"]
    kw = dict(generator=generator, device=generator.device)
    return {
        "noise": torch.randn((batch_size, s, s, cfg["architecture"]["z_dim"]), **kw),
        "offset": int(torch.randint(0, max(1, t + 1 - window_frames(cfg)), (), **kw)),
        "idx_t": torch.randint(0, batch_size * (t + 1), (n_ex,), **kw),
        "idx_f": torch.randint(0, batch_size * t, (n_ex,), **kw),
    }


def adams(cfg, nets: FirstStageNets):
    t = cfg["training"]
    return [torch.optim.Adam(list(getattr(nets, n).parameters()), lr=t["lr"], betas=BETAS,
                             eps=EPS, weight_decay=t["weight_decay"]) for n in NETS]


class Step:
    """One step with gates 1 (no pretraining, no KL annealing)."""

    def __init__(self, cfg, nets: FirstStageNets, opts):
        self.nets, self.opts = nets, opts
        self.mf_dt = window_frames(cfg)
        t, dt = cfg["training"], cfg["d_t"]
        self.gp_w, self.w_kl, self.w_l1, self.w_vgg = (
            dt["gp_weight"], t["w_kl"], t["w_l1"], t["w_vgg"])
        self.gen_w, self.fmap_w = dt["gen_weight"], dt["fmap_weight"]
        nets.vgg.requires_grad_(False)

    def window(self, v, draws):
        return v[:, draws["offset"]:draws["offset"] + self.mf_dt]

    @staticmethod
    def frames(v, idx):
        return v.reshape(-1, *v.shape[2:])[idx]

    @staticmethod
    def apply(opt, loss):
        params = opt.param_groups[0]["params"]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def __call__(self, batch, draws):
        model, d_s, d_t = self.nets.model, self.nets.disc_s, self.nets.disc_t
        X = batch["images"]
        with torch.no_grad():  # the fake videos; their spectral-norm stats are dropped
            saved = [(m, m.u, m.sigma) for m in model.modules() if getattr(m, "snorm", False)]
            X_hat = model(X, draws["noise"], train=True)[0]
            for m, u, sigma in saved:
                m.u, m.sigma = u, sigma
        true_w = self.window(X, draws)
        fake_w = self.window(torch.cat([X[:, :1], X_hat], dim=1), draws)
        pred_true = d_t(true_w)[0]
        gp = gradient_penalty(lambda v: d_t(v)[0], true_w).mean()
        pred_fake = d_t(fake_w, train=True)[0]
        loss_dt = 0.5 * (hinge_d_loss(pred_fake, False) + hinge_d_loss(pred_true, True))
        self.apply(self.opts[2], loss_dt + self.gp_w * gp)

        pred_true = d_s(self.frames(X, draws["idx_t"]))[0]
        pred_fake = d_s(self.frames(X_hat, draws["idx_f"]), train=True)[0]
        loss_ds = 0.5 * (hinge_d_loss(pred_fake, False) + hinge_d_loss(pred_true, True))
        self.apply(self.opts[1], loss_ds)

        X_hat, mu, logvar = model(X, draws["noise"], train=True)
        fake_w = self.window(torch.cat([X[:, :1], X_hat], dim=1), draws)
        pred_fake_s = d_s(self.frames(X_hat, draws["idx_f"]))[0]
        pred_fake_t, fmap_fake = d_t(fake_w)
        with torch.no_grad():
            fmap_true = d_t(self.window(X, draws))[1]
        loss = (gen_loss(pred_fake_s) + self.gen_w * gen_loss(pred_fake_t)
                + self.fmap_w * fmap_loss(fmap_fake, fmap_true)
                + self.w_vgg * vgg_loss(self.nets.vgg, X[:, 1:].reshape(-1, *X.shape[2:]),
                                        X_hat.reshape(-1, *X_hat.shape[2:]))
                + self.w_kl * kl_loss(mu, logvar)
                + self.w_l1 * (X[:, 1:] - X_hat).abs().mean())
        self.apply(self.opts[0], loss)
        return {"loss": loss.detach(), "loss_d_dt": loss_dt.detach(),
                "loss_d_ds": loss_ds.detach()}
