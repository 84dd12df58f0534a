"""FVD feature backbone (counterpart of ``ipoke_tpu/eval/backbone.py``).

The JAX package's default: the in-repo-trained MotionFeatureNet from the
packaged ``ipoke_tpu/eval/weights/motion_feat_v1.npz``, read by path as a
data file (the port imports nothing of ``ipoke_tpu``).  The kinetics and
random I3D choices (``eval/i3d.py``) are not ported (ROADMAP queue 1 item
7): where the packaged file is absent this raises instead of falling back.
"""

from __future__ import annotations

import os

from ..nn.motion_feat import MotionFeatureNet, load_motion_feat

_PACKAGED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "ipoke_tpu", "eval", "weights", "motion_feat_v1.npz")


def packaged_weights_path() -> str:
    return _PACKAGED


def init_fvd_backbone(device="cpu") -> MotionFeatureNet:
    """The trained MotionFeatureNet on ``device``."""
    if os.environ.get("IPOKE_I3D_WEIGHTS") or \
            os.environ.get("IPOKE_FVD_BACKBONE", "") == "random_i3d":
        raise NotImplementedError(
            "the I3D FVD backbones are not ported yet (ROADMAP queue 1 item 7)")
    if not os.path.exists(_PACKAGED):
        raise FileNotFoundError(
            f"the FVD backbone's weights {_PACKAGED} are missing; the I3D "
            "fallback is not ported (ROADMAP queue 1 item 7)")
    return load_motion_feat(_PACKAGED, device)
