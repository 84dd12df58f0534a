"""Second-stage conditional INN, sampling direction (counterpart of
``ipoke_tpu/models/second_stage.py``): a multi-scale MaCow cINN maps
z ~ N(0, I) back to the frozen first stage's motion latent, conditioned on
``h = [phi(x_0), phi(poke)]`` from the frozen conditioner and poke embedder,
and the first stage decodes it to video."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..flows import ParamTree, build_macow_transformer
from ..nn.encoders import FirstStageWrapper
from .first_stage import FirstStageModel


class SecondStageModel(nn.Module):
    """The sampling model: ``flow`` is the static cINN description,
    ``flow_params`` its parameter tree; the three frozen nets are
    submodules."""

    def __init__(self, config, first_stage: FirstStageModel,
                 conditioner: FirstStageWrapper,
                 poke_embedder: FirstStageWrapper, flow_params=None):
        super().__init__()
        arch = config["architecture"]
        self.first_stage = first_stage
        self.conditioner = conditioner
        self.poke_embedder = poke_embedder
        if arch.get("augmented_input", False):
            raise NotImplementedError("augmented_input is not ported yet")
        for size, name in ((poke_embedder.min_spatial_size, "poke embedder"),
                           (conditioner.min_spatial_size, "conditioner")):
            if size != first_stage.min_spatial_size:
                raise NotImplementedError(
                    f"conv_adapt ({name} latent {size} vs first stage "
                    f"{first_stage.min_spatial_size}) is not ported yet")
        flow_in = first_stage.z_dim
        h_channels = poke_embedder.nf_max + conditioner.nf_max
        self.flow = build_macow_transformer(dict(
            arch, flow_in_channels=flow_in, h_channels=h_channels,
            flow_mid_channels=int(arch.get("flow_mid_channels_factor", 8)
                                  * flow_in)))
        self.flow_in_channels = flow_in
        self.min_spatial_size = first_stage.min_spatial_size
        self.flow_params = ParamTree(flow_params) if flow_params is not None \
            else None

    def embed_conditioning(self, batch):
        """h = [phi(x_0), phi(poke)] (B, s, s, Ch)."""
        poke_emb, _, _ = self.poke_embedder.encode(batch["poke"])
        cond, _, _ = self.conditioner.encode(batch["images"][:, 0])
        return torch.cat([cond, poke_emb], dim=-1)

    @torch.no_grad()
    def forward_sample(self, batch, length: int,
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None):
        """Sample videos (B, T, H, W, 3): z ~ N(0, I) (or the given ``z``),
        the cINN inverse, then the first-stage decode.  z and the work run in
        the dtype of ``batch["images"]``."""
        x = batch["images"]
        s = self.min_spatial_size
        cond = self.embed_conditioning(batch)
        if z is None:
            z = torch.randn((x.shape[0], s, s, self.flow_in_channels),
                            generator=generator, device=x.device,
                            dtype=x.dtype)
        motion = self.flow.inverse(self.flow_params.tree(), z, cond)
        return self.first_stage.decode(motion, x[:, 0], length)
