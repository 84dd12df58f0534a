"""Flow NLL losses (counterpart of ``ipoke_tpu/flows/loss.py``): every
reduction in fp32, so that a bf16 latent loses no digits in ||z||^2.

``radial`` is the FC second stage's radial base distribution (reference
``loss.py:20-28``): the NLL ``dof * log r + r^2 / 2`` of the sample's norm
r, with ``dof = sum(sample.shape[1:]) - 1`` on the (B, 1, 1, D) view of a
vector latent (the sum of the dims, not their product: the reference's
quirk, kept).

``flow_loss_alternative``, ``gaussian_logp`` and ``nll_with_typicality``
are the reference's other objectives; no config selects them."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def nll(sample, spatial_mean: bool = False, radial: bool = False):
    """Per-sample negative log-likelihood under N(0, I) (or the radial
    base), up to a constant.  ``sample``: (B, H, W, C) or (B, D)."""
    sample = sample.float()
    if sample.ndim == 2:
        sample = sample[:, None, None, :]
    if radial:
        r = torch.linalg.vector_norm(sample.reshape(sample.shape[0], -1), dim=1)
        dof = sum(sample.shape[1:]) - 1.0
        return dof * torch.log(r) + 0.5 * r ** 2
    if spatial_mean:
        return 0.5 * torch.sum(torch.mean(sample ** 2, dim=(1, 2)), dim=-1)
    return 0.5 * torch.sum(sample.reshape(sample.shape[0], -1) ** 2, dim=1)


def radial_sample(shape, generator: Optional[torch.Generator] = None,
                  device=None, dtype=None):
    """A draw of the radial base: a uniform direction (N(0, I) over its norm
    plus 1e-12) times |N(0, 1)| per sample, the second draw after the
    first (``SecondStageModelFC.sample_base`` of the JAX package)."""
    z = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    flat = z.reshape(shape[0], -1)
    r = torch.randn((shape[0], 1), generator=generator, device=device,
                    dtype=dtype).abs()
    flat = flat / (torch.linalg.vector_norm(flat, dim=1, keepdim=True) + 1e-12)
    return (flat * r).reshape(shape)


def flow_loss(sample, logdet, generator: Optional[torch.Generator] = None,
              spatial_mean: bool = False,
              reference: Optional[torch.Tensor] = None, radial: bool = False):
    """NLL + negative-logdet objective, both weighted 1 (the JAX package's
    defaults, which the trainer uses); returns (loss, log dict).

    ``generator`` enables the ``reference_nll_loss`` diagnostic: the NLL of a
    fresh sample of the base (N(0, I), or ``radial_sample``) of the same
    shape, drawn from it; ``reference`` gives that sample instead."""
    logdet = logdet.float()
    nll_loss = torch.mean(nll(sample, spatial_mean=spatial_mean, radial=radial))
    nlogdet = -torch.mean(logdet)
    if spatial_mean and sample.ndim == 4:
        nlogdet = nlogdet / (sample.shape[1] * sample.shape[2])
    loss = nll_loss + nlogdet
    log = {"flow_loss": loss, "nlogdet_loss": nlogdet, "nll_loss": nll_loss}
    if reference is None and generator is not None:
        draw = radial_sample if radial else torch.randn
        reference = draw(sample.shape, generator=generator,
                         device=sample.device, dtype=sample.dtype)
    if reference is not None:
        log["reference_nll_loss"] = torch.mean(nll(
            reference, spatial_mean=spatial_mean, radial=radial))
    return loss, log


def flow_loss_alternative(sample, logdet):
    """The channel-sum NLL variant (reference ``FlowLossAlternative``):
    mean over the batch of 0.5 ||z||^2, minus the mean logdet."""
    flat = sample.reshape(sample.shape[0], -1)
    nll_loss = torch.mean(torch.sum(0.5 * flat ** 2, dim=1))
    nlogdet = -torch.mean(logdet)
    loss = nll_loss + nlogdet
    return loss, {"flow_loss": loss, "nll_loss": nll_loss, "nlogdet_loss": nlogdet}


def gaussian_logp(z, logdet):
    """The exact Gaussian log-likelihood with its 2 pi constant (reference
    ``GaussianLogP``); returns (bits-per-dim loss, log dict)."""
    dim = int(np.prod(z.shape[1:]))
    log = lambda v: torch.log(torch.tensor(v, device=z.device))  # fp32, as jnp.log
    log_p = -0.5 * torch.sum(z.reshape(z.shape[0], -1) ** 2, dim=1) \
        - 0.5 * dim * log(2 * math.pi)
    ll = torch.mean(log_p + logdet)
    loss = -ll / (dim * log(2.0))
    return loss, {"flow_loss": loss, "log_likelihood": ll}


def nll_with_typicality(sample, logdet, step, fade_steps: int = 10000,
                        typicality_weight: float = 1.0):
    """``flow_loss`` plus an entropy-matching (typicality) term faded in
    linearly over ``fade_steps`` (reference ``NLLWithTypicality``): the
    squared gap between the batch's mean energy 0.5 ||z||^2 and the
    Gaussian's, 0.5 * dim, over dim."""
    dim = int(np.prod(sample.shape[1:]))
    energy = torch.mean(0.5 * torch.sum(sample.reshape(sample.shape[0], -1) ** 2, dim=1))
    typicality = (energy - 0.5 * dim) ** 2 / dim
    base, log = flow_loss(sample, logdet)
    w = typicality_weight * min(max(float(step) / fade_steps, 0.0), 1.0)
    loss = base + w * typicality
    return loss, dict(log, typicality=typicality, typicality_w=w, flow_loss=loss)
