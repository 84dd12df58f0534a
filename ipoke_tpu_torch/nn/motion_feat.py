"""MotionFeatureNet, the default FVD feature backbone (counterpart of
``ipoke_tpu/nn/motion_feat.py``): three 3x3x3 conv stages (spatial stride 2,
flax "SAME" padding, so a stride-2 axis of even size pads one row after and
none before), GroupNorm(8, eps 1e-6) and ReLU, a temporal average pool of 2
after stages 1 and 2 (zeros padded after an odd length and counted, as
flax's ``avg_pool``), a global mean, and a 128-d dense feature.  Its weights
are the JAX package's committed fp16 file
(``ipoke_tpu/eval/weights/motion_feat_v1.npz``), read by path as data;
videos are (B, T, H, W, 3) in [-1, 1].  The pretext heads are not carried.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FEAT_DIM = 128


def _same_pad(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class MotionFeatureNet(nn.Module):
    def __init__(self, widths=(32, 64, 128)):
        super().__init__()
        self.widths = tuple(widths)
        cin = 3
        for i, w in enumerate(self.widths):
            self.add_module(f"conv{i}", nn.Conv3d(cin, w, 3, (1, 2, 2)))
            self.add_module(f"gn{i}", nn.GroupNorm(8, w, eps=1e-6))
            cin = w
        self.feat = nn.Linear(cin, FEAT_DIM)

    def forward(self, v):
        """(B, FEAT_DIM) features of videos (B, T, H, W, 3)."""
        x = v.permute(0, 4, 1, 2, 3)  # NCDHW
        for i in range(len(self.widths)):
            pads = []
            for size, s in zip(reversed(x.shape[2:]), (2, 2, 1)):
                pads += _same_pad(size, 3, s)
            x = getattr(self, f"conv{i}")(F.pad(x, pads))
            x = F.relu(getattr(self, f"gn{i}")(x))
            if i > 0:  # temporal average pool of 2, flax SAME
                lo, hi = _same_pad(x.shape[2], 2, 2)
                x = F.avg_pool3d(F.pad(x, (0, 0, 0, 0, lo, hi)), (2, 1, 1))
        return self.feat(x.mean(dim=(2, 3, 4)))


def load_motion_feat(path: str, device="cpu") -> MotionFeatureNet:
    """The net with the committed fp16 weights of ``path`` (flat keys
    ``params/<layer>/<leaf>``) as fp32, in eval mode."""
    data = np.load(path)
    net = MotionFeatureNet()

    def get(key):
        if key not in data.files:
            raise KeyError(f"{path}: missing weight {key}")
        return torch.as_tensor(data[key].astype(np.float32))

    with torch.no_grad():
        for i in range(len(net.widths)):
            conv, gn = getattr(net, f"conv{i}"), getattr(net, f"gn{i}")
            conv.weight.copy_(get(f"params/conv{i}/kernel").permute(4, 3, 0, 1, 2))
            conv.bias.copy_(get(f"params/conv{i}/bias"))
            gn.weight.copy_(get(f"params/gn{i}/scale"))
            gn.bias.copy_(get(f"params/gn{i}/bias"))
        net.feat.weight.copy_(get("params/feat/kernel").t())
        net.feat.bias.copy_(get("params/feat/bias"))
    return net.to(device).eval().requires_grad_(False)


@torch.no_grad()
def motion_feat_activations(net: MotionFeatureNet, videos,
                            batch_size: int = 16) -> np.ndarray:
    """Feature matrix (N, FEAT_DIM) float32 of ``videos`` (a tensor or an
    array), in slices of ``batch_size`` on the net's device; every clip
    counts, the last short slice too."""
    dev = next(net.parameters()).device
    outs = []
    for i in range(0, videos.shape[0], batch_size):
        v = torch.as_tensor(videos[i:i + batch_size]).to(dev, torch.float32)
        outs.append(net(v).float().cpu().numpy())
    return np.concatenate(outs, axis=0)
