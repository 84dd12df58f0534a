"""Pose estimation for the keypoint metrics (counterpart of
``ipoke_tpu/eval/pose.py``; reference SimpleBaselines pose-ResNet,
``models/pose_estimator/lib/models/pose_resnet.py``, and ``get_max_preds``,
``lib/core/inference.py``).

A bottleneck ResNet with inference BatchNorm (eps 1e-5), three k4/s2/p1
deconvs (torch ``ConvTranspose2d``, flax's ``'VALID'`` transpose cropped
by one pixel) and a 1x1 head give (B, H/4, W/4, K) heatmaps of NHWC frames
in [-1, 1].  Names repeat flax's, so ``convert.load_flax`` maps the JAX
package's variables onto the net.

Weights: ``IPOKE_POSE_WEIGHTS`` names a converted torch pose-ResNet npz
(``load_torch_pose_resnet_npz``; the stage plan is read from its keys),
else a fixed-seed ResNet-50 plan (fan-in normal convs, unit BN, from a CPU
generator; the values are not JAX's).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import BatchNorm, Conv, ConvTransposeTK

_BN_EPS = 1e-5
# COCO-17 joints; the reference's head: three 256-channel k4 deconvs
N_JOINTS, DECONV_CHANNELS, N_DECONV = 17, 256, 3


class _Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, BN after each, a 1x1-BN projection of the
    input where the shape changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, _BN_EPS)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes, _BN_EPS)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4, _BN_EPS)
        if downsample:
            self.downsample_conv = Conv(cin, planes * 4, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(planes * 4, _BN_EPS)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.downsample_bn(self.downsample_conv(x)) \
            if hasattr(self, "downsample_conv") else x
        return F.relu(out + residual)


class PoseResNet(nn.Module):
    """``layers`` (3, 4, 6, 3) is ResNet-50, (3, 8, 36, 3) the reference's
    pose_resnet152."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, _BN_EPS)
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), self.layers)):
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_{j}",
                                _Bottleneck(cin, planes, stride, downsample=j == 0))
                cin = planes * 4
        for m in range(N_DECONV):
            self.add_module(f"deconv{m}", ConvTransposeTK(cin, DECONV_CHANNELS))
            self.add_module(f"deconv_bn{m}", BatchNorm(DECONV_CHANNELS, _BN_EPS))
            cin = DECONV_CHANNELS
        self.final = Conv(cin, N_JOINTS, 1)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for i, n in enumerate(self.layers):
            for j in range(n):
                h = getattr(self, f"layer{i + 1}_{j}")(h)
        for m in range(N_DECONV):
            h = F.relu(getattr(self, f"deconv_bn{m}")(getattr(self, f"deconv{m}")(h)))
        return self.final(h)


def get_max_preds(heatmaps) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heatmaps (B, h, w, K) -> ((B, K, 2) [x, y] of the first argmax,
    (B, K) maxvals); the coordinates are -1 where maxval <= 0."""
    b, _, w, k = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(b, k, -1)
    maxvals, idx = flat.amax(dim=-1), flat.argmax(dim=-1)
    coords = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    coords = torch.where(maxvals[..., None] > 0, coords, torch.full_like(coords, -1.0))
    return coords, maxvals


class PoseEstimator:
    """Frames (B, H, W, 3) in [-1, 1] -> keypoints (B, K, 2) as (x, y) in
    pixels of the input frame (reference ``utils/posenet_wrapper.py``)."""

    def __init__(self, net: PoseResNet):
        self.net = net

    @torch.no_grad()
    def __call__(self, frames) -> np.ndarray:
        dev = next(self.net.parameters()).device
        x = torch.as_tensor(frames).to(dev, torch.float32)
        hm = self.net(x)
        coords, _ = get_max_preds(hm)
        return coords.cpu().numpy() * (x.shape[1] / hm.shape[1])


def keypoint_nearest_neighbors(kps: np.ndarray, exclude_same: np.ndarray,
                               chunk: int = 1024) -> np.ndarray:
    """For each sample, the index of its keypoint-space nearest neighbour
    with a different group id (reference data prep ``meta_kp_nn.p``,
    prepare_dataset.py:461-516), row-chunked: O(chunk * n) memory."""
    flat = kps.reshape(kps.shape[0], -1).astype(np.float64)
    n = flat.shape[0]
    sq = np.sum(flat**2, axis=1)
    out = np.empty(n, np.int64)
    groups = np.asarray(exclude_same)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        d2 = sq[i0:i1, None] + sq[None, :] - 2.0 * (flat[i0:i1] @ flat.T)
        d2[groups[i0:i1, None] == groups[None, :]] = np.inf
        out[i0:i1] = np.argmin(d2, axis=1)
    return out


def keypoint_mse(kps_a: np.ndarray, kps_b: np.ndarray,
                 norm: float = 1.0) -> np.ndarray:
    """Per-sample mean squared keypoint distance (reference ``KPSMetric``,
    utils/metrics.py:324-396)."""
    d = (np.asarray(kps_a) - np.asarray(kps_b)) / norm
    return np.mean(np.sum(d ** 2, axis=-1), axis=-1)


def build_pose_resnet(layers: Sequence[int] = (3, 4, 6, 3), seed: int = 0,
                      device="cpu") -> PoseResNet:
    """Fixed-seed random weights from a CPU generator (the same on every
    device); eval, no grad."""
    from ..entry import materialize

    with torch.device("meta"):
        net = PoseResNet(layers=layers)
    net = materialize(net, "cpu", torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for sub in net.modules():
            if isinstance(sub, BatchNorm):
                sub.scale.fill_(1.0)
                sub.bias.zero_()
                sub.mean.zero_()
                sub.var.fill_(1.0)
            elif isinstance(sub, ConvTransposeTK):
                w = sub.weight
                w.normal_(0.0, (w.shape[0] * w.shape[2] * w.shape[3]) ** -0.5,
                          generator=torch.Generator().manual_seed(seed + 1))
    return net.to(device).eval().requires_grad_(False)


def _conv_t(w):
    return torch.as_tensor(np.ascontiguousarray(w))


def convert_torch_pose_resnet(state: dict, net: PoseResNet) -> PoseResNet:
    """A torch pose-ResNet state_dict (numpy leaves; pose_resnet.py's keys)
    into ``net``, in place."""
    own = {}

    def bn(dst, src):
        for a, b in (("scale", "weight"), ("bias", "bias"),
                     ("mean", "running_mean"), ("var", "running_var")):
            own[f"{dst}.{a}"] = state[f"{src}.{b}"]

    own["conv1.weight"] = state["conv1.weight"]
    bn("bn1", "bn1")
    for i, n in enumerate(net.layers):
        for j in range(n):
            t, d = f"layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for k in (1, 2, 3):
                own[f"{d}.conv{k}.weight"] = state[f"{t}.conv{k}.weight"]
                bn(f"{d}.bn{k}", f"{t}.bn{k}")
            if f"{t}.downsample.0.weight" in state:
                own[f"{d}.downsample_conv.weight"] = state[f"{t}.downsample.0.weight"]
                bn(f"{d}.downsample_bn", f"{t}.downsample.1")
    for m in range(N_DECONV):
        own[f"deconv{m}.weight"] = state[f"deconv_layers.{3 * m}.weight"]
        bn(f"deconv_bn{m}", f"deconv_layers.{3 * m + 1}")
    own["final.weight"] = state["final_layer.weight"]
    own["final.bias"] = state["final_layer.bias"]
    sd = net.state_dict()
    if set(own) != set(sd):
        raise KeyError(f"pose-ResNet keys differ: {sorted(set(sd) ^ set(own))[:4]}")
    net.load_state_dict({k: _conv_t(v) for k, v in own.items()})
    return net


def stage_plan(keys) -> Tuple[int, ...]:
    """The blocks per stage of a torch pose-ResNet state_dict's keys."""
    return tuple(max(int(k.split(".")[1]) for k in keys
                     if k.startswith(f"layer{s}.")) + 1 for s in (1, 2, 3, 4))


def load_torch_pose_resnet_npz(path: str, device="cpu") -> PoseResNet:
    """A dumped torch pose-ResNet state_dict (.npz) as the port's net on
    ``device``, its stage plan read from the keys."""
    raw = np.load(path)
    state = {k: raw[k] for k in raw.files}
    net = build_pose_resnet(stage_plan(state))
    return convert_torch_pose_resnet(state, net).to(device)


def pose_estimator_from_env(device) -> PoseEstimator:
    """The one place that resolves pose weights: ``IPOKE_POSE_WEIGHTS``'s
    npz, else a fixed-seed ResNet-50 plan."""
    path = os.environ.get("IPOKE_POSE_WEIGHTS")
    net = load_torch_pose_resnet_npz(path, device) if path \
        else build_pose_resnet(device=device)
    return PoseEstimator(net)
