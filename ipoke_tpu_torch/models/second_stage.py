"""Second-stage conditional INN (counterpart of
``ipoke_tpu/models/second_stage.py``): a multi-scale MaCow cINN maps the
frozen first stage's motion latent to z ~ N(0, I) (the density direction that
training fits by NLL) and back (sampling), conditioned on
``h = [phi(x_0), phi(poke)]`` from the frozen conditioner and poke embedder
(``phi(poke)`` alone without a conditioner); the first stage decodes a
sampled latent to video.

``poke_embedder.flow_ae`` embeds the batch's ``flow`` in place of its
``poke``; a ``poke_and_image`` embedder takes the start frame appended to
it.  A variational conditioner conditions on its mean.

``flow_params`` holds the JAX package's whole second-stage tree when the
model has more than the flow to train: ``{"flow": ...}`` with
``scale_augment`` and ``shift_augment`` under ``architecture.augmented_input``
(``scale_augment * N(0, 1) + shift_augment``, drawn for each density pass
and DDI, appended to the motion latent and dropped after the sampling
inverse), and ``adapt_poke`` / ``adapt_cond`` under ``conv_adapt``, when an
embedder's latent is larger or smaller than the first stage's: a strided 3x3
conv (flax ``nn.Conv(padding=1)``: ``{"kernel", "bias"}``) or a
``Conv2dTransposeBlock(norm="group")`` (``{"ConvTranspose_0",
"GroupNorm_0"}``), in flax's layout.  The adapters train with the flow and
run outside the frozen nets' ``no_grad``.  Otherwise ``flow_params`` is the
flow's tree alone (``init_params``)."""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.optim import cast_floats
from ..flows import ParamTree, build_macow_transformer, flow_loss
from ..flows.base import randn
from ..nn.blocks import _num_groups, conv_transpose, group_norm, promote
from ..nn.encoders import FirstStageWrapper
from .first_stage import FirstStageModel


class SecondStageModel(nn.Module):
    """``flow`` is the static cINN description, ``flow_params`` its parameter
    tree; the frozen nets are submodules (``conditioner`` may be None).
    ``config`` carries the ``architecture`` block, optionally the
    ``poke_embedder`` block (``flow_ae``) and, for training, the
    ``training`` block."""

    def __init__(self, config, first_stage: FirstStageModel,
                 conditioner: Optional[FirstStageWrapper],
                 poke_embedder: FirstStageWrapper, flow_params=None):
        super().__init__()
        self.config = config
        arch = config["architecture"]
        self.first_stage = first_stage
        self.conditioner = conditioner
        self.poke_embedder = poke_embedder
        self.poke_key = "flow" if (config.get("poke_embedder") or {}).get(
            "flow_ae", False) else "poke"
        self.min_spatial_size = s = first_stage.min_spatial_size
        # conv_adapt: the embedders' latent sizes, where they differ from s
        self.adapters = {
            key: (net.min_spatial_size, net.nf_max)
            for key, net in (("adapt_poke", poke_embedder), ("adapt_cond", conditioner))
            if net is not None and net.min_spatial_size != s}
        for src, _ in self.adapters.values():
            if max(src, s) % min(src, s):
                raise ValueError(f"conv_adapt: latent size {src} against {s}")
        self.augment_channels = int(arch.get("augment_channels", 0)) \
            if arch.get("augmented_input", False) else 0
        self.wraps_flow = bool(self.augment_channels or self.adapters)
        flow_in = first_stage.z_dim + self.augment_channels
        h_channels = poke_embedder.nf_max + (conditioner.nf_max if conditioner else 0)
        self.flow = build_macow_transformer(dict(
            arch, flow_in_channels=flow_in, h_channels=h_channels,
            flow_mid_channels=int(arch.get("flow_mid_channels_factor", 8)
                                  * flow_in)))
        self.flow_in_channels = flow_in
        self.flow_params = ParamTree(flow_params) if flow_params is not None \
            else None

    def init_params(self, generator, device):
        """A new second-stage tree: the flow's init, with ``augmented_input``
        the augmentation's scale (ones) and shift (zeros), and each
        ``conv_adapt`` adapter (fan-in-scaled normal kernels, zero biases,
        unit GroupNorm scales)."""
        tree = self.flow.init(generator, device)
        if not self.wraps_flow:
            return tree
        tree = {"flow": tree}
        if self.augment_channels:
            c = self.augment_channels
            tree.update(scale_augment=torch.ones(c, device=device),
                        shift_augment=torch.zeros(c, device=device))
        for key, (src, nf) in self.adapters.items():
            kernel = randn((3, 3, nf, nf), generator, device, (9 * nf) ** -0.5)
            bias = torch.zeros(nf, device=device)
            if src > self.min_spatial_size:
                tree[key] = {"kernel": kernel, "bias": bias}
            else:
                tree[key] = {"ConvTranspose_0": {"kernel": kernel, "bias": bias},
                             "GroupNorm_0": {"scale": torch.ones(nf, device=device),
                                             "bias": torch.zeros(nf, device=device)}}
        return tree

    def flow_tree(self):
        """The flow's parameter tree (inside ``flow_params``)."""
        tree = self.flow_params.tree()
        return tree["flow"] if self.wraps_flow else tree

    def augment(self, motion, generator=None, noise=None):
        """``motion`` with the augmentation channels appended: ``noise``
        (B, s, s, augment_channels), or N(0, 1) drawn from ``generator``,
        scaled and shifted by the trainable per-channel params."""
        if not self.augment_channels:
            return motion
        if noise is None:
            noise = torch.randn((*motion.shape[:-1], self.augment_channels),
                                generator=generator, device=motion.device,
                                dtype=motion.dtype)
        tree = self.flow_params.tree()
        aug = tree["scale_augment"] * noise.to(motion.dtype) + tree["shift_augment"]
        return torch.cat([motion, aug], dim=-1)

    def embed_frozen(self, batch):
        """(phi(x_0) or None, phi(poke)) from the frozen nets at their own
        latent sizes: the poke (or flow, ``flow_ae``) with the start frame
        appended for a ``poke_and_image`` embedder; a variational
        conditioner's mean."""
        X = batch["images"]
        poke = batch[self.poke_key]
        if self.poke_embedder.poke_and_image:
            poke = torch.cat([poke, X[:, 0]], dim=-1)
        poke_emb = self.poke_embedder.encode(poke)[0]
        if self.conditioner is None:
            return None, poke_emb
        z, mean, _ = self.conditioner.encode(X[:, 0])
        return (z if self.conditioner.deterministic else mean), poke_emb

    def adapt(self, key, x):
        """The ``conv_adapt`` adapter ``key`` on an embedder's latent ``x``
        (``x`` itself where the sizes agree): flax's promotion of input and
        params, as its layers are built without a dtype."""
        if key not in self.adapters:
            return x
        p = self.flow_params.tree()[key]
        src, nf = self.adapters[key]
        dst = self.min_spatial_size
        if src > dst:
            x, w, b = promote(None, x, p["kernel"], p["bias"])
            y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                         stride=src // dst, padding=1)
            return y.permute(0, 2, 3, 1)
        ct, gn = p["ConvTranspose_0"], p["GroupNorm_0"]
        x, w, b = promote(None, x, ct["kernel"], ct["bias"])
        y = conv_transpose(x, torch.flip(w, (0, 1)).permute(2, 3, 0, 1), b, 3,
                           dst // src)
        return F.elu(group_norm(y, _num_groups(nf), gn["scale"], gn["bias"]))

    def join(self, cond, poke_emb):
        """h: the adapted embeddings, [phi(x_0), phi(poke)] on the channel
        axis (phi(poke) alone without a conditioner)."""
        poke_emb = self.adapt("adapt_poke", poke_emb)
        if cond is None:
            return poke_emb
        return torch.cat([self.adapt("adapt_cond", cond), poke_emb], dim=-1)

    def embed_conditioning(self, batch):
        """h (B, s, s, Ch)."""
        return self.join(*self.embed_frozen(batch))

    def encode_first_stage(self, X, generator: Optional[torch.Generator] = None):
        """The motion latent of the clip ``X``: a sample drawn from
        ``generator`` (mu without one, or when deterministic)."""
        motion, _, _ = self.first_stage.encode(X, generator)
        return motion

    def _flow_input(self, batch, generator):
        """(motion, h): the frozen nets outside autograd (the JAX package's
        stop-gradient: it differentiates the flow params and the adapters
        only), then the adapters."""
        with torch.no_grad():
            cond, poke_emb = self.embed_frozen(batch)
            motion = self.encode_first_stage(batch["images"], generator)
        # a first stage trained under mixed_prec computes in bf16: the flow
        # takes its input in its params' dtype, as JAX promotes it
        dtype = next(self.flow_params.parameters()).dtype
        cast = lambda t: None if t is None else t.to(dtype)
        return motion.to(dtype), self.join(cast(cond), cast(poke_emb))

    def forward_density(self, batch, generator: Optional[torch.Generator] = None,
                        aug_noise: Optional[torch.Tensor] = None):
        """(z, logdet) of the batch's motion latent for NLL training; the
        augmentation's noise (``augmented_input``) is ``aug_noise`` or drawn
        from ``generator`` after the motion sample."""
        motion, cond = self._flow_input(batch, generator)
        x = self.augment(motion, generator, aug_noise)
        return self.flow.forward(self.flow_tree(), x, cond)

    @torch.no_grad()
    def ddi(self, batch, generator: Optional[torch.Generator] = None,
            aug_noise: Optional[torch.Tensor] = None):
        """Data-dependent init of the flow from one batch: the new
        ``flow_params`` tree (``flow_params.load_tree`` takes it in)."""
        motion, cond = self._flow_input(batch, generator)
        x = self.augment(motion, generator, aug_noise)
        new = self.flow.ddi(self.flow_tree(), x, cond)[2]
        if not self.wraps_flow:
            return new
        return dict(self.flow_params.tree(), flow=new)

    def z_shape(self):
        """One sample's base draw: the flow's output shape at the motion
        latent's (the reshaped one of a ``MultiscaleStack``)."""
        s = self.min_spatial_size
        return self.flow.output_shape((s, s, self.flow_in_channels))

    @torch.no_grad()
    def forward_sample(self, batch, length: int,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None, mesh=None):
        """Sample videos (B, T, H, W, 3): z ~ N(0, I) at ``z_shape`` (or the
        given ``z``), the cINN inverse, then the first-stage decode.  z and
        the work run in the dtype of ``batch["images"]``.

        ``mesh`` (``ipoke_tpu_torch.parallel``; the model's params sharded
        by ``shard_params``): ``batch`` is the whole batch on every rank;
        every rank draws the whole z from ``generator`` and keeps its slice
        of the batch and of z, and the videos are gathered over the data
        ranks, so the result is the single device's."""
        x = batch["images"]
        if z is None:
            z = torch.randn((x.shape[0], *self.z_shape()), generator=generator,
                            device=x.device, dtype=x.dtype)
        if mesh is not None:
            from ..parallel.mesh import gather_batch, shard_batch

            batch, z = shard_batch((batch, z), mesh)
            with mesh:
                return gather_batch(self.forward_sample(batch, length, z=z), mesh)
        x = batch["images"]
        cond = self.embed_conditioning(batch)
        motion = self.flow.inverse(self.flow_tree(), z, cond)
        motion = motion[..., :self.first_stage.z_dim]
        return self.first_stage.decode(motion, x[:, 0], length)


def create_second_stage_state(model: SecondStageModel, make_tx: Callable):
    """The optimizer over the flow's trainable leaves (which it switches to
    ``requires_grad``); the frozen nets stay frozen.  The port's train state
    is the model's own params plus this optimizer."""
    model.requires_grad_(False)
    return make_tx(model.flow_params.trainable())


def make_second_stage_train_step(model: SecondStageModel, tx, mesh=None) -> Callable:
    """``step(batch, generator=None) -> log``: density forward, NLL, backward,
    one optimizer step.  Under ``training.mixed_prec_master`` the batch is
    cast to bf16 to match the bf16-resident params; the loss and logdet
    reductions are fp32.  ``generator`` draws the motion sample and the
    ``reference_nll_loss`` diagnostic's sample.

    ``mesh`` (``ipoke_tpu_torch.parallel``): the model's params are this
    rank's shard (``shard_params``) and ``batch`` its slice of the batch
    (``shard_batch``).  The step runs its slice on its shard, averages the
    gradients over the data ranks (a bucketed all-reduce, as DDP does)
    before the optimizer, and returns the logs averaged over them.  The
    clip by global norm and Adafactor's factored moments would need the
    whole of a split leaf: with a model axis the step refuses them."""
    tcfg = model.config.get("training", {})
    spatial_mean = bool(tcfg.get("spatial_mean", False))
    mixed = bool(tcfg.get("mixed_prec_master", False))
    radial = bool(getattr(model, "radial", False))  # the FC second stage's option
    clip = getattr(getattr(tx, "inner", tx), "clip", 0)  # master_weights wraps
    if mesh is not None and mesh.tp > 1 and (
            clip > 0 or tcfg.get("use_adafactor", False)):
        raise NotImplementedError(
            "a model_parallel mesh step takes neither clip_grad_norm nor "
            "Adafactor: both read the whole of a split w2")

    def step(batch, generator: Optional[torch.Generator] = None):
        if mixed:
            batch = cast_floats(batch, torch.bfloat16)
        with contextlib.nullcontext() if mesh is None else mesh:
            z, logdet = model.forward_density(batch, generator)
            loss, log = flow_loss(z, logdet, generator=generator,
                                  spatial_mean=spatial_mean, radial=radial)
            loss.backward()
        log = {k: v.detach() for k, v in log.items()}
        if mesh is not None:
            from ..parallel.mesh import average_grads, mean_over_batch

            average_grads(model.flow_params.parameters(), mesh)
            log = mean_over_batch(log, mesh)
        tx.step()
        return log

    return step
