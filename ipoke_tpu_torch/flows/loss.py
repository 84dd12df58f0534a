"""Flow NLL losses (counterpart of ``ipoke_tpu/flows/loss.py``): every
reduction in fp32, so that a bf16 latent loses no digits in ||z||^2."""

from __future__ import annotations

from typing import Optional

import torch


def nll(sample, spatial_mean: bool = False):
    """Per-sample negative log-likelihood under N(0, I), up to a constant.
    ``sample``: (B, H, W, C) or (B, D)."""
    sample = sample.float()
    if sample.ndim == 2:
        sample = sample[:, None, None, :]
    if spatial_mean:
        return 0.5 * torch.sum(torch.mean(sample ** 2, dim=(1, 2)), dim=-1)
    return 0.5 * torch.sum(sample.reshape(sample.shape[0], -1) ** 2, dim=1)


def flow_loss(sample, logdet, generator: Optional[torch.Generator] = None,
              spatial_mean: bool = False,
              reference: Optional[torch.Tensor] = None):
    """NLL + negative-logdet objective, both weighted 1 (the JAX package's
    defaults, which the trainer uses); returns (loss, log dict).

    ``generator`` enables the ``reference_nll_loss`` diagnostic: the NLL of a
    fresh N(0, I) sample of the same shape, drawn from it; ``reference``
    gives that sample instead."""
    logdet = logdet.float()
    nll_loss = torch.mean(nll(sample, spatial_mean=spatial_mean))
    nlogdet = -torch.mean(logdet)
    if spatial_mean and sample.ndim == 4:
        nlogdet = nlogdet / (sample.shape[1] * sample.shape[2])
    loss = nll_loss + nlogdet
    log = {"flow_loss": loss, "nlogdet_loss": nlogdet, "nll_loss": nll_loss}
    if reference is None and generator is not None:
        reference = torch.randn(sample.shape, generator=generator,
                                device=sample.device, dtype=sample.dtype)
    if reference is not None:
        log["reference_nll_loss"] = torch.mean(nll(reference,
                                                   spatial_mean=spatial_mean))
    return loss, log
