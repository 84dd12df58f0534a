"""MotionFeatureNet, the default FVD feature backbone (counterpart of
``ipoke_tpu/nn/motion_feat.py``): three 3x3x3 conv stages (spatial stride 2,
flax "SAME" padding, so a stride-2 axis of even size pads one row after and
none before), GroupNorm(8, eps 1e-6) and ReLU, a temporal average pool of 2
after stages 1 and 2 (zeros padded after an odd length and counted, as
flax's ``avg_pool``), a global mean, and a 128-d dense feature.  Its weights
are the JAX package's committed fp16 file
(``ipoke_tpu/eval/weights/motion_feat_v1.npz``), read by path as data;
videos are (B, T, H, W, 3) in [-1, 1].

Its pretext training (``ipoke_tpu_torch/scripts/train_motion_feat.py``)
builds it with the two heads (``init_motion_feat``): the clip's motion
statistics (``motion_targets``) from the ReLU of the feature, and a
temporal-order logit; ``save_motion_feat`` writes the flat fp16 npz that
both packages' ``load_motion_feat`` read.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FEAT_DIM = 128
# regression targets: (mean_dx, mean_dy, mean |flow|, moving-area fraction)
N_MOTION_TARGETS = 4


def _same_pad(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class MotionFeatureNet(nn.Module):
    def __init__(self, widths=(32, 64, 128), heads: bool = False):
        super().__init__()
        self.widths = tuple(widths)
        cin = 3
        for i, w in enumerate(self.widths):
            self.add_module(f"conv{i}", nn.Conv3d(cin, w, 3, (1, 2, 2)))
            self.add_module(f"gn{i}", nn.GroupNorm(8, w, eps=1e-6))
            cin = w
        self.feat = nn.Linear(cin, FEAT_DIM)
        if heads:
            self.motion_head = nn.Linear(FEAT_DIM, N_MOTION_TARGETS)
            self.order_head = nn.Linear(FEAT_DIM, 1)

    def forward(self, v, return_heads: bool = False):
        """(B, FEAT_DIM) features of videos (B, T, H, W, 3); with
        ``return_heads`` (feature, motion (B, 4), order logit (B,))."""
        feat = self.features(v)
        if not return_heads:
            return feat
        h = F.relu(feat)
        return feat, self.motion_head(h), self.order_head(h)[..., 0]

    def features(self, v):
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


def motion_targets(flow: np.ndarray) -> np.ndarray:
    """Per-clip regression targets from the flow maps (B, H, W, 2): the mean
    flow vector and amplitude over the moving pixels (|flow| > 1e-3), over
    the spatial size, and the moving-area fraction."""
    s = float(flow.shape[1])
    mag = np.linalg.norm(flow, axis=-1)
    moving = mag > 1e-3
    area = moving.mean(axis=(1, 2))
    denom = np.maximum(moving.sum(axis=(1, 2)), 1)[:, None]
    mean_vec = (flow * moving[..., None]).sum(axis=(1, 2)) / denom
    mean_mag = (mag * moving).sum(axis=(1, 2)) / denom[:, 0]
    return np.stack([mean_vec[:, 0] / s, mean_vec[:, 1] / s, mean_mag / s, area],
                    axis=-1).astype(np.float32)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: a normal truncated at 2 std, scaled to
    variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_motion_feat(generator: torch.Generator, device="cpu") -> MotionFeatureNet:
    """The net with its pretext heads, initialised as flax does (lecun
    normal kernels, zero biases, GroupNorm scale 1), drawn from
    ``generator``."""
    net = MotionFeatureNet(heads=True)
    for m in net.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)
    return net.to(device)


def _layers(net: MotionFeatureNet):
    """(name, module) of every layer in the flat key order of the npz."""
    names = [n for i in range(len(net.widths)) for n in (f"conv{i}", f"gn{i}")]
    names += ["feat"] + [n for n in ("motion_head", "order_head") if hasattr(net, n)]
    return [(n, getattr(net, n)) for n in names]


def save_motion_feat(net: MotionFeatureNet, path: str) -> None:
    """The JAX package's flat fp16 npz (``params/<layer>/<leaf>``: DHWIO and
    (in, out) kernels, GroupNorm ``scale``), compressed."""
    flat = {}
    for name, m in _layers(net):
        w, b = m.weight.detach().float().cpu(), m.bias.detach().float().cpu()
        if isinstance(m, nn.Conv3d):
            w, leaf = w.permute(2, 3, 4, 1, 0), "kernel"
        elif isinstance(m, nn.Linear):
            w, leaf = w.t(), "kernel"
        else:
            leaf = "scale"
        flat[f"params/{name}/{leaf}"] = w.numpy().astype(np.float16)
        flat[f"params/{name}/bias"] = b.numpy().astype(np.float16)
    np.savez_compressed(path, **flat)


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
