"""Plain reference of ``SecondStageModel.forward_sample``: the frozen
conditioner and poke embedder, the cINN's inverse from z, the ConvGRU and
the SPADE decode, in fp32 (TF32 off), NHWC.  Imports nothing of the port.

    h = [enc_cond(x_0), enc_poke(poke)]; motion = flow^-1(z; h)[..., :z_dim]
    frames = decode(motion, x_0, T)
"""

from __future__ import annotations

import torch
from torch import nn

from .flow import MultiScaleInternal, tree_fill, tree_specs
from .nets import FirstStageModel, FirstStageWrapper, specs

FLOW_PREFIX = ("flow_params",)


class CinnSample(nn.Module):
    """``cfg``: the configuration's ``model`` block (the port's
    ``entry.make_model`` keys: spatial, min_spatial, T, z_dim, dec_ch,
    nf_cond, num_steps, mid_factor, factor; and ``n_gru_layers``) and
    ``flow_perturb``, the stds of the flow's out-conv gains (``shift``,
    ``scale``: by output half) and of its biases and ActNorms (``scale``),
    ``flow.tree_specs``."""

    def __init__(self, cfg):
        super().__init__()
        s, m, nf = cfg["spatial"], cfg["min_spatial"], cfg["nf_cond"]
        self.z_dim = cfg["z_dim"]
        self.first_stage = FirstStageModel(s, cfg["z_dim"], tuple(cfg["dec_ch"]),
                                           cfg["n_gru_layers"], m)
        self.conditioner = FirstStageWrapper(s, 3, nf, m)
        self.poke_embedder = FirstStageWrapper(s, 2, nf, m)
        self.flow = MultiScaleInternal(tuple(cfg["num_steps"]), cfg["z_dim"],
                                       cfg["mid_factor"] * cfg["z_dim"], 2 * nf,
                                       cfg.get("factor", 16))
        self.z_shape = (m, m, cfg["z_dim"])
        self.flow_perturb = cfg["flow_perturb"]

    def specs(self):
        """How every weight is drawn: the nets', then the flow tree's under
        ``flow_params``."""
        return specs(self) + tree_specs(self.flow.init(), FLOW_PREFIX, self.flow_perturb)

    def flow_tree(self, values):
        return tree_fill(self.flow.init(), values, FLOW_PREFIX)

    @torch.no_grad()
    def sample(self, tree, images, poke, z, length):
        h = torch.cat([self.conditioner.encoder(images[:, 0]),
                       self.poke_embedder.encoder(poke)], dim=-1)
        motion = self.flow.inverse(tree, z, h)[..., :self.z_dim]
        return self.first_stage.decode(motion, images[:, 0], length)


def build(cfg) -> CinnSample:
    """The reference on ``meta`` (``to_empty`` and ``load_state_dict`` give
    it weights)."""
    with torch.device("meta"):
        return CinnSample(cfg)
