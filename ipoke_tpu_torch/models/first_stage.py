"""First-stage video VAE-GAN (counterpart of ``ipoke_tpu/models/first_stage.py``).

The model: 3D-ResNet motion encoder -> z_m (B, s, s, z_dim) -> ConvGRU
rollout from the learned motion bias -> SPADE-conditioned conv decoder per
frame.  Sampling and second-stage training run it frozen (``encode``, the
batched eval ``decode``); the first stage trains it (``forward`` with
``train``, frame by frame) in ``FirstStageStep``: the
generator forward, then the temporal discriminator's update (hinge + R1
penalty on a random window), the spatial discriminator's (random frames),
and the generator's (hinge, feature matching, VGG, L1, KL), in the JAX
package's order, with the discriminators gated by ``disc_gate``.  The
same step trains the FC baseline (``models.fc_baseline.FCBaselineModel``,
``architecture.fc_baseline``), whose motion latent is a vector, and the
PokeVAE baseline (``models.poke_vae.PokeVAEModel``,
``architecture.baseline``), whose generator forwards take the batch's poke.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.blocks import set_compute_dtype
from ..nn.discriminators import (
    PatchDiscriminator2D,
    ResNet3DDiscriminator,
    fmap_loss,
    gen_loss,
    gradient_penalty,
    hinge_d_loss,
)
from ..nn.encoders import SpadeCondConvDecoder
from ..nn.gru import ConvGRU
from ..nn.motion import ResNetMotionEncoder
from ..nn.vgg import vgg_loss


def kl_loss(mu, logvar):
    """Channel-sum, mean elsewhere."""
    return -0.5 * torch.mean(
        torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))


class FirstStageModel(nn.Module):
    def __init__(self, spatial_size: int, z_dim: int = 32,
                 dec_channels: Sequence[int] = (256, 256, 256, 128, 64),
                 n_gru_layers: int = 4, min_spatial_size: int = 8,
                 norm: str = "group",
                 enc_channels: Optional[Sequence[int]] = None,
                 max_frames: int = 10, deterministic: bool = False,
                 spectral_norm: bool = False, full_seq: bool = True,
                 use_motion_bias: bool = True, torch_compat: bool = False):
        """``enc_channels`` None leaves the motion encoder out (sampling
        does not run it).  ``spectral_norm`` keeps the decoder's spectral
        norm live (training); frozen models take it collapsed.
        ``full_seq`` encodes the whole clip, else the T frames after the
        start frame (``training.full_sequence``).  Without
        ``use_motion_bias`` the ConvGRU's input is the motion latent itself
        (``architecture.motion_bias: false``); ``torch_compat`` decodes with
        the reference's semantics (``SpadeCondConvDecoder``) and without
        spectral norm, as the JAX package builds it for ported weights."""
        super().__init__()
        self.spatial_size, self.z_dim = spatial_size, z_dim
        self.deterministic, self.full_seq = deterministic, full_seq
        if enc_channels is not None:
            self.enc_motion = ResNetMotionEncoder(
                enc_channels, z_dim, spatial_size, max_frames,
                min_spatial_size, deterministic, full_seq)
        self.n_gru_layers, self.min_spatial_size = n_gru_layers, min_spatial_size
        self.rnn = ConvGRU(z_dim, z_dim, n_gru_layers)
        self.motion_bias = nn.Parameter(torch.empty(
            1, min_spatial_size, min_spatial_size, z_dim)) if use_motion_bias else None
        self.gen = SpadeCondConvDecoder(
            z_dim, dec_channels, 3, norm, snorm=spectral_norm and not torch_compat,
            torch_compat=torch_compat)

    def forward(self, X, train: bool = False, noise=None):
        """(X_hat (B, T, H, W, 3), mu, logvar) of the clip ``X`` (B, T+1, H,
        W, 3): the clip encoded (``encode``), z = noise * exp(logvar / 2) +
        mu (mu without ``noise`` or when deterministic), decoded from the
        start frame over T frames."""
        motion, mu, logvar = self.enc_motion(self._encoded(X), noise=noise)
        return self.decode(motion, X[:, 0], X.shape[1] - 1, train), mu, logvar

    def _encoded(self, X):
        return X if self.full_seq else X[:, 1:]

    def encode(self, X, generator: Optional[torch.Generator] = None):
        """(z, mu, logvar) of the clip ``X`` (B, T+1, H, W, 3): all of it
        with ``full_seq``, else its T frames after the start frame; z = mu
        without a generator or when deterministic."""
        return self.enc_motion(self._encoded(X), generator)

    def decode(self, motion, start_frame, length: int, train: bool = False):
        """ConvGRU rollout over ``length`` frames from ``motion`` (B, s, s,
        z), with the per-clip SPADE modulations computed once from the start
        frame.  Eval: one batched SPADE decode of all B*T frames (B-major).
        Train: the decoder renders frame by frame, each call advancing every
        spectral norm's ``u``, so frame t runs on the u of t updates (the
        JAX package's ``nn.scan`` carrying ``batch_stats``).  Returns (B, T,
        H, W, 3)."""
        hidden = tuple(motion for _ in range(self.n_gru_layers))
        in_rnn = motion if self.motion_bias is None \
            else self.motion_bias.expand(motion.shape[0], -1, -1, -1)
        mods = self.gen.spade_modulations(start_frame, motion.shape[1])
        hs, frames = [], []
        for _ in range(length):
            hidden = self.rnn(in_rnn, hidden)
            if train:
                frames.append(self.gen(hidden[-1], mods, train=True))
            else:
                hs.append(hidden[-1])
        if train:
            return torch.stack(frames, dim=1)
        flat = torch.stack(hs, dim=1).flatten(0, 1)  # frame index b*T + t
        frames = self.gen(flat, mods)
        return frames.reshape(motion.shape[0], length, *frames.shape[1:])


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _dt_frames(config) -> int:
    return min(config["d_t"].get("max_frames", 8), config["data"]["max_frames"] + 1)


def latent_shape(config) -> tuple:
    """The motion latent's shape without the batch: (s, s, z_dim) maps, or
    (z_dim,) vectors for the FC baseline."""
    arch = config["architecture"]
    if arch.get("fc_baseline", False):
        return (arch["z_dim"],)
    s = arch.get("min_spatial_size", 8)
    return (s, s, arch["z_dim"])


def sample_draws(generator: torch.Generator, config, batch_size: int) -> dict:
    """One step's random numbers, on ``generator``'s device: the encoder
    noise (B, *latent_shape), shared by both generator forwards; the d_t
    window's start in [0, max(1, T+1 - window)); and ``n_examples`` real and
    fake frame indices for d_s, drawn with replacement."""
    T, n_ex = config["data"]["max_frames"], config["d_s"].get("n_examples", 16)
    kw = dict(generator=generator, device=generator.device)
    return {
        "noise": torch.randn((batch_size, *latent_shape(config)), **kw),
        "offset": int(torch.randint(0, max(1, T + 1 - _dt_frames(config)), (),
                                    **kw)),
        "idx_t": torch.randint(0, batch_size * (T + 1), (n_ex,), **kw),
        "idx_f": torch.randint(0, batch_size * T, (n_ex,), **kw),
    }


def create_first_stage_state(model, disc_s, disc_t, make_tx):
    """The three optimizers (generator, d_s, d_t), each ``make_tx(params)``
    over one net's parameters."""
    return tuple(make_tx(list(net.parameters())) for net in (model, disc_s, disc_t))


class FirstStageStep:
    """The JAX package's ``make_first_stage_train_step``: ``step(batch,
    draws, disc_gate, kl_gate=1.0) -> metrics``, in its order; the phases
    are methods so that a caller can time them.

    * ``fake``: the generator forward without grad (its spectral-norm stats
      are discarded, as in JAX);
    * ``update_dt``: d_t's loss on the window; the real and gradient-penalty
      passes run in eval on the old u, the fake pass in train mode (run last,
      it stores the new u);
    * ``update_ds``: the same on the sampled frames;
    * ``update_g``: the generator forward again from the old u, with grad
      (its stats are the step's new ones), against both discriminators with
      their new params and u in eval.

    A model that ``needs_poke`` (the PokeVAE) gets ``batch["poke"]`` in
    both generator forwards.  With ``disc_gate`` 0 the discriminators' optimizer steps are skipped
    (params and moments stay; their u still advances, as in JAX)."""

    def __init__(self, config, model, disc_s, disc_t, vgg, tx_g, tx_ds, tx_dt):
        tcfg, dtc = config["training"], config["d_t"]
        self.model, self.disc_s, self.disc_t, self.vgg = model, disc_s, disc_t, vgg
        self.tx_g, self.tx_ds, self.tx_dt = tx_g, tx_ds, tx_dt
        self.mf_dt = _dt_frames(config)
        self.gp_weight = dtc.get("gp_weight", 0.0)
        self.w_kl, self.w_l1, self.w_vgg = tcfg["w_kl"], tcfg["w_l1"], tcfg["w_vgg"]
        self.gen_w, self.fmap_w = dtc.get("gen_weight", 1.0), dtc.get("fmap_weight", 1.0)
        for p in vgg.parameters():
            p.requires_grad_(False)

    def window(self, V, draws):
        return V[:, draws["offset"]:draws["offset"] + self.mf_dt]

    @staticmethod
    def frames(V, idx):
        return V.reshape(-1, *V.shape[2:])[idx]

    @staticmethod
    def _apply(tx, loss, disc_gate) -> None:
        if disc_gate > 0:
            grads = torch.autograd.grad(loss, tx.params, allow_unused=True)
            for p, g in zip(tx.params, grads):
                p.grad = g
            tx.step()

    def _poke(self, poke):
        return {"poke": poke} if getattr(self.model, "needs_poke", False) else {}

    def fake(self, X, draws, poke=None):
        with torch.no_grad():
            saved = [(m, m.u, m.sigma) for m in self.model.modules()
                     if getattr(m, "snorm", False)]
            X_hat = self.model(X, train=True, noise=draws["noise"], **self._poke(poke))[0]
            for m, u, sigma in saved:  # discarded, as the JAX step does
                m.u, m.sigma = u, sigma
        return X_hat

    def update_dt(self, X, X_hat, draws, disc_gate):
        d = self.disc_t
        X_true_w = self.window(X, draws)
        X_fake_w = self.window(torch.cat([X[:, :1], X_hat], dim=1), draws)
        pred_true = d(X_true_w, train=False)[0]
        gp = X.new_zeros(())
        if self.gp_weight > 0:
            gp = gradient_penalty(lambda v: d(v, train=False)[0], X_true_w).mean()
        pred_fake = d(X_fake_w, train=True)[0]
        loss = 0.5 * (hinge_d_loss(pred_fake, False) + hinge_d_loss(pred_true, True))
        self._apply(self.tx_dt, disc_gate * (loss + self.gp_weight * gp), disc_gate)
        return loss.detach(), gp.detach()

    def update_ds(self, X, X_hat, draws, disc_gate):
        d = self.disc_s
        pred_true = d(self.frames(X, draws["idx_t"]), train=False)[0]
        pred_fake = d(self.frames(X_hat, draws["idx_f"]), train=True)[0]
        loss = 0.5 * (hinge_d_loss(pred_fake, False) + hinge_d_loss(pred_true, True))
        self._apply(self.tx_ds, disc_gate * loss, disc_gate)
        return loss.detach()

    def update_g(self, X, draws, disc_gate, kl_gate=1.0, poke=None):
        X_hat, mu, logvar = self.model(X, train=True, noise=draws["noise"],
                                       **self._poke(poke))
        X_fake_w = self.window(torch.cat([X[:, :1], X_hat], dim=1), draws)
        pred_fake_s = self.disc_s(self.frames(X_hat, draws["idx_f"]))[0]
        pred_fake_t, fmap_fake = self.disc_t(X_fake_w)
        with torch.no_grad():
            fmap_true = self.disc_t(self.window(X, draws))[1]
        l_gen_s, l_gen_t = gen_loss(pred_fake_s), gen_loss(pred_fake_t)
        l_fmap = fmap_loss(fmap_fake, fmap_true)
        l_vgg = vgg_loss(self.vgg, X[:, 1:].reshape(-1, *X.shape[2:]),
                         X_hat.reshape(-1, *X_hat.shape[2:]))
        l_l1 = (X[:, 1:] - X_hat).abs().mean()
        l_kl = X.new_zeros(()) if self.model.deterministic else kl_loss(mu, logvar)
        loss = (disc_gate * (l_gen_s + self.gen_w * l_gen_t + self.fmap_w * l_fmap)
                + self.w_vgg * l_vgg + kl_gate * self.w_kl * l_kl
                + self.w_l1 * l_l1)
        self._apply(self.tx_g, loss, 1.0)
        return {"loss_g_s": l_gen_s, "loss_g_t": l_gen_t, "loss_fmap_t": l_fmap,
                "l_vgg": l_vgg, "l_rec": l_l1, "l_kl": l_kl, "loss": loss}

    def __call__(self, batch, draws, disc_gate: float, kl_gate: float = 1.0):
        X, poke = batch["images"], batch.get("poke")
        X_hat = self.fake(X, draws, poke)
        loss_dt, gp_dt = self.update_dt(X, X_hat, draws, disc_gate)
        loss_ds = self.update_ds(X, X_hat, draws, disc_gate)
        metrics = self.update_g(X, draws, disc_gate, kl_gate, poke)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss_d_dt=loss_dt, loss_gp_dt=gp_dt, loss_d_ds=loss_ds)
        return metrics


def build_fc_baseline(config):
    """The FC baseline first stage (``architecture.fc_baseline``).  Its
    generator renders 4 * 2^(len(dec_channels) - 1) px whatever
    ``data.spatial_size`` says; where the two differ, the JAX package's
    step fails on the frames' shapes, so this raises at build."""
    from .fc_baseline import FCBaselineModel

    arch, size = config["architecture"], config["data"]["spatial_size"][0]
    out = 4 * 2 ** (len(arch["dec_channels"]) - 1)
    if out != size:
        raise ValueError(
            f"the FC baseline's generator renders {out} px from "
            f"{len(arch['dec_channels'])} dec_channels, but data.spatial_size "
            f"is {size}")
    return FCBaselineModel(
        size, z_dim=arch["z_dim"], enc_channels=tuple(arch["ENC_M_channels"]),
        dec_channels=tuple(arch["dec_channels"]),
        n_gru_layers=arch.get("n_gru_layers", 2),
        use_spade=arch.get("CN_content", "spade") == "spade",
        deterministic=arch.get("deterministic", False),
        full_seq=bool(config["training"].get("full_sequence", True)))


def build_first_stage(config):
    """(model, disc_s, disc_t) of a reference-style config tree, on the
    current default device, fp32 params, weights uninitialised (``entry``
    fills them); ``architecture.fc_baseline`` builds ``build_fc_baseline``'s,
    ``architecture.baseline`` the PokeVAE (``models.poke_vae``).
    Under ``training.mixed_prec`` all three compute in bf16 as the JAX
    package's ``dtype=bfloat16`` nets do (``nn.blocks.set_compute_dtype``)."""
    arch, dcfg, tcfg = config["architecture"], config["data"], config["training"]
    full_seq = bool(tcfg.get("full_sequence", True))
    if arch.get("fc_baseline", False):
        model = build_fc_baseline(config)
    elif arch.get("baseline", False):
        from .poke_vae import PokeVAEModel

        model = PokeVAEModel(
            dcfg["spatial_size"][0], z_dim=arch["z_dim"],
            enc_channels=tuple(arch["ENC_M_channels"]),
            dec_channels=tuple(arch["dec_channels"]),
            n_gru_layers=arch.get("n_gru_layers", 4),
            min_spatial_size=arch.get("min_spatial_size", 8),
            max_frames=dcfg["max_frames"], full_seq=full_seq,
            stack_motion_and_poke=arch.get("stack_motion_and_poke", False),
            norm=arch.get("norm", "group"),
            spectral_norm=arch.get("spectral_norm", True))
    else:
        model = FirstStageModel(
            dcfg["spatial_size"][0], z_dim=arch["z_dim"],
            dec_channels=tuple(arch["dec_channels"]),
            n_gru_layers=arch.get("n_gru_layers", 4),
            min_spatial_size=arch.get("min_spatial_size", 8),
            norm=arch.get("norm", "group"),
            enc_channels=tuple(arch["ENC_M_channels"]),
            max_frames=dcfg["max_frames"],
            deterministic=arch.get("deterministic", False),
            spectral_norm=arch.get("spectral_norm", True), full_seq=full_seq,
            use_motion_bias=arch.get("motion_bias", True),
            torch_compat=arch.get("torch_compat", False))
    disc_s = PatchDiscriminator2D(ndf=config["d_s"].get("ndf", 64),
                                  n_layers=config["d_s"].get("n_layers", 3))
    disc_t = ResNet3DDiscriminator(
        layers=tuple(config["d_t"].get("layers", (1, 1, 1, 1))),
        patch_temp_disc=config["d_t"].get("patch_temp_disc", False))
    nets = (model, disc_s, disc_t)
    if tcfg.get("mixed_prec", False):  # flax's dtype=bf16 over fp32 params
        for net in nets:
            set_compute_dtype(net, torch.bfloat16)
    return nets
