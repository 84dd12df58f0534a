"""Optical-flow errors (counterpart of ``ipoke_tpu/eval/metrics.py``
``angular_error`` and ``endpoint_error``, reference utils/metrics.py:20-83),
per pixel of NHWC flow maps (..., 2)."""

from __future__ import annotations

import torch


def angular_error(f1, f2):
    """The angle between flow vectors extended with a unit third
    component."""
    ones = f1.new_ones((*f1.shape[:-1], 1))
    a, b = torch.cat([f1, ones], dim=-1), torch.cat([f2, ones], dim=-1)
    cos = (a * b).sum(dim=-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def endpoint_error(f1, f2):
    return (f1 - f2).norm(dim=-1)
