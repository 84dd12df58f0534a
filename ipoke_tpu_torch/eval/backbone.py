"""FVD feature backbone (counterpart of ``ipoke_tpu/eval/backbone.py``).

The JAX package's priority:

1. ``IPOKE_I3D_WEIGHTS`` -> the converted kinetics I3D;
2. ``IPOKE_FVD_BACKBONE=random_i3d`` -> a fixed-seed I3D;
3. the packaged ``ipoke_tpu/eval/weights/motion_feat_v1.npz`` -> the
   in-repo-trained MotionFeatureNet, read by path as a data file (the port
   imports nothing of ``ipoke_tpu``);
4. else (the packaged file absent and ``IPOKE_FVD_BACKBONE`` not
   ``motion_feat``) a fixed-seed I3D.

The backbone is the net itself; ``backbone_activations`` dispatches on its
type.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..nn.motion_feat import MotionFeatureNet, load_motion_feat, motion_feat_activations
from .i3d import I3D, i3d_activations, init_i3d

_PACKAGED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "ipoke_tpu", "eval", "weights", "motion_feat_v1.npz")


def packaged_weights_path() -> str:
    return _PACKAGED


def init_fvd_backbone(device) -> torch.nn.Module:
    """The FVD backbone on ``device`` by the priority above (the port's nets
    take any clip size)."""
    forced = os.environ.get("IPOKE_FVD_BACKBONE", "")
    if os.environ.get("IPOKE_I3D_WEIGHTS") or forced == "random_i3d" or (
            not os.path.exists(_PACKAGED) and forced != "motion_feat"):
        return init_i3d(0, device)
    return load_motion_feat(_PACKAGED, device)


def backbone_activations(backbone, videos, batch_size: int = 8) -> np.ndarray:
    """The (N, D) feature matrix of ``videos`` (N, T, H, W, 3) in [-1, 1]
    for the Fréchet moments."""
    if isinstance(backbone, MotionFeatureNet):
        return motion_feat_activations(backbone, videos, batch_size)
    if isinstance(backbone, I3D):
        return i3d_activations(backbone, videos, batch_size)
    raise TypeError(f"no FVD activations for {type(backbone).__name__}")
