"""RAFT optical-flow estimator (Teed & Deng, ECCV 2020; counterpart of
``ipoke_tpu/nn/raft.py``), the learned estimator of the data prep
(``data/prep.py``'s ``raft``), with its supervised and self-supervised
training loops.

NCHW throughout.  Submodules carry the official RAFT ``state_dict`` keys
(``fnet``/``cnet`` BasicEncoders, ``update_block.encoder`` /
``.gru`` / ``.flow_head`` / ``.mask``), so an official ``raft-things``
checkpoint loads with ``load_state_dict`` (``load_torch_raft_npz``), and the
JAX package's ``convert_torch_raft`` maps this module's ``state_dict`` onto
its flax tree.  As in the JAX package:

* ``cnet``'s BatchNorm always normalises with its running statistics, in
  training too (``_FrozenBatchNorm``); its scale and bias learn;
* the refinement loop carries the flow without detaching it between
  iterations (official RAFT detaches; the JAX scan does not);
* the correlation lookup is a four-corner gather with zero padding, not
  ``F.grid_sample`` (which divides by ``W - 1`` and breaks at a 1-pixel
  pyramid level).

The all-pairs correlation is one ``torch.matmul``; the convolutions are
cuDNN's on the card.  No kernel of ``ops/`` runs here.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.optim import clip_by_global_norm_

# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


class _FrozenBatchNorm(nn.Module):
    """BatchNorm2d that always uses its running statistics (flax
    ``BatchNorm(use_running_average=True)``, eps 1e-5): ``train()`` does not
    change it and no step updates the statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=1e-5)


def _norm(kind: str, c: int) -> nn.Module:
    """cnet's frozen BatchNorm, or fnet's InstanceNorm (no affine, no
    running statistics: per-sample mean and biased variance, eps 1e-5)."""
    return _FrozenBatchNorm(c) if kind == "batch" else nn.InstanceNorm2d(c)


class _ResUnit(nn.Module):
    """The official ResidualBlock: two 3x3 convs with norm and ReLU, a 1x1
    projection (``downsample``, its norm also registered as ``norm3``)
    where the stride or the width changes."""

    def __init__(self, cin: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1, self.norm2 = _norm(norm, planes), _norm(norm, planes)
        if stride != 1 or cin != planes:
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride), self.norm3)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """1/8-resolution feature tower: a 7x7 stride-2 stem, three residual
    stages (stride 1, 2, 2; widths base, 1.5 base, 2 base), a 1x1 out."""

    def __init__(self, output_dim: int = 256, norm: str = "instance", base: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, base, 7, 2, 3)
        self.norm1 = _norm(norm, base)
        cin = base
        for i, w in enumerate((base, int(base * 1.5), base * 2)):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                _ResUnit(cin, w, 1 if i == 0 else 2, norm), _ResUnit(w, w, 1, norm)))
            cin = w
        self.conv2 = nn.Conv2d(cin, output_dim, 1)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = self.layer3(self.layer2(self.layer1(h)))
        return self.conv2(h)


# ---------------------------------------------------------------------------
# Correlation pyramid + lookup
# ---------------------------------------------------------------------------


def corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """All-pairs correlation of (B, D, H, W) feature maps over sqrt(D), as
    (B*H*W, 1, H, W) maps over the target pixels, then ``num_levels - 1``
    2x2 average pools of the target dims (floor sizes: a level pooled past
    one pixel is empty, as flax's ``avg_pool`` gives it)."""
    B, D, H, W = fmap1.shape
    corr = torch.matmul(fmap1.reshape(B, D, H * W).transpose(1, 2),
                        fmap2.reshape(B, D, H * W)) / math.sqrt(D)
    levels = [corr.reshape(B * H * W, 1, H, W)]
    for _ in range(num_levels - 1):
        last = levels[-1]
        levels.append(F.avg_pool2d(last, 2, 2) if min(last.shape[2:]) >= 2
                      else last.new_zeros(*last.shape[:2], *(s // 2 for s in last.shape[2:])))
    return levels


def bilinear_sample(img, coords):
    """img (N, C, H, W), coords (N, P, 2) as pixel (x, y) -> (N, C, P);
    zero outside (each of the four corners gathered and masked alone; all
    of an empty image)."""
    N, C, H, W = img.shape
    if H * W == 0:
        return img.new_zeros(N, C, coords.shape[1])
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    flat = img.reshape(N, C, H * W)

    def gather(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        out = torch.gather(flat, 2, idx[:, None, :].expand(N, C, idx.shape[1]))
        return out * inb[:, None].to(img.dtype)

    v00, v01 = gather(x0, y0), gather(x0 + 1, y0)
    v10, v11 = gather(x0, y0 + 1), gather(x0 + 1, y0 + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def corr_lookup(levels: Sequence[torch.Tensor], coords, radius: int = 4):
    """The (2r+1)^2 window around ``coords / 2^l`` at every pyramid level.

    coords (B, 2, H, W) in source pixels -> (B, L*(2r+1)^2, H, W).  Channel
    ``l*(2r+1)^2 + i*(2r+1) + j`` samples the offset (o[i], o[j]) as (x, y),
    the official CorrBlock's meshgrid order."""
    B, _, H, W = coords.shape
    o = torch.arange(-radius, radius + 1, device=coords.device, dtype=coords.dtype)
    d = torch.stack(torch.meshgrid(o, o, indexing="ij"), dim=-1).reshape(1, -1, 2)
    flat = coords.permute(0, 2, 3, 1).reshape(B * H * W, 1, 2)
    out = [bilinear_sample(corr, flat / (2.0 ** lvl) + d).reshape(B, H, W, -1)
           for lvl, corr in enumerate(levels)]
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Update block
# ---------------------------------------------------------------------------


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """A 1x5 then a 5x1 convolutional GRU over (hidden, input)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        for tag, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in ("z", "r", "q"):
                self.add_module(f"conv{g}{tag}", nn.Conv2d(
                    hidden_dim + input_dim, hidden_dim, k, padding=pad))

    def _gru(self, h, x, tag):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
        q = torch.tanh(getattr(self, f"convq{tag}")(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._gru(self._gru(h, x, "1"), x, "2")


class FlowHead(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden_dim: int = 128, context_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, context_dim + 128)
        self.flow_head = FlowHead(hidden_dim)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        m = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, m], dim=1))
        return net, self.flow_head(net), 0.25 * self.mask(net)


# ---------------------------------------------------------------------------
# RAFT
# ---------------------------------------------------------------------------


def convex_upsample(flow, mask):
    """Learned 8x upsampling of (B, 2, H, W): each fine pixel a softmax-
    weighted combination of its 3x3 coarse neighbourhood (zero padded) of
    8x the flow.  mask (B, 576, H, W) holds the weights as (9, 8, 8)."""
    B, _, H, W = flow.shape
    m = torch.softmax(mask.reshape(B, 9, 8, 8, H, W), dim=1)
    f = F.pad(flow * 8.0, (1, 1, 1, 1))
    neigh = torch.stack([f[:, :, dy:dy + H, dx:dx + W]
                         for dy in range(3) for dx in range(3)], dim=1)  # (B, 9, 2, H, W)
    up = torch.einsum("bkuvhw,bkchw->bcuvhw", m, neigh)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, H * 8, W * 8)


def _coords_grid(B, H, W, device, dtype):
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=dtype),
                            torch.arange(W, device=device, dtype=dtype), indexing="ij")
    return torch.stack([xs, ys])[None].expand(B, 2, H, W)


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    feature_dim: int = 256
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    base: int = 64  # encoder width; 32 -> a "small" variant


class RAFT(nn.Module):
    """Images (B, 3, H, W) in [-1, 1], H and W multiples of 8 -> flow
    (B, 2, H, W) in pixels (x right, y down: the prep ``.flow.npy``
    convention)."""

    def __init__(self, cfg: Optional[RAFTConfig] = None):
        super().__init__()
        self.cfg = cfg = cfg or RAFTConfig()
        self.fnet = BasicEncoder(cfg.feature_dim, "instance", cfg.base)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch", cfg.base)
        self.update_block = BasicUpdateBlock(
            cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2, cfg.hidden_dim,
            cfg.context_dim)

    def forward(self, image1, image2, iters: Optional[int] = None,
                with_intermediate: bool = False):
        cfg = self.cfg
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], dim=0)).chunk(2, dim=0)
        levels = corr_pyramid(fmap1, fmap2, cfg.corr_levels)
        c = self.cnet(image1)
        net = torch.tanh(c[:, :cfg.hidden_dim])
        inp = F.relu(c[:, cfg.hidden_dim:])
        B, _, H, W = fmap1.shape
        coords0 = _coords_grid(B, H, W, fmap1.device, fmap1.dtype)
        flow = torch.zeros_like(coords0)
        flows, ups = [], []
        for _ in range(iters or cfg.iters):  # one weight-tied update block
            corr = corr_lookup(levels, coords0 + flow, cfg.corr_radius)
            net, dflow, mask = self.update_block(net, inp, corr, flow)
            flow = flow + dflow
            flows.append(flow)
            ups.append(convex_upsample(flow, mask))
        if with_intermediate:
            return ups[-1], (torch.stack(flows), torch.stack(ups))
        return ups[-1]


def init_raft(cfg: Optional[RAFTConfig] = None, seed: int = 0, device="cpu") -> RAFT:
    """Fixed-seed weights drawn on the CPU (the same on every device):
    fan-in-scaled normal conv weights, zero biases, unit BatchNorm."""
    net = RAFT(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=gen)
                m.bias.zero_()
    return net.to(device)


# ---------------------------------------------------------------------------
# Training (synthetic supervision, self-supervised fine-tuning)
# ---------------------------------------------------------------------------


def sequence_loss(flow_preds_up, flow_gt, gamma: float = 0.8):
    """Exponentially weighted L1 over the iterations' upsampled flows
    (n, B, 2, H, W) against (B, 2, H, W) (official sequence_loss)."""
    n = flow_preds_up.shape[0]
    w = gamma ** torch.arange(n - 1, -1, -1, device=flow_gt.device, dtype=flow_gt.dtype)
    l1 = (flow_preds_up - flow_gt[None]).abs().mean(dim=(1, 2, 3, 4))
    return (w * l1).sum()


def make_optimizer(model: RAFT, lr: float):
    """optax ``adamw(lr, weight_decay=1e-5)`` over every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-5)


def _train_step(model: RAFT, opt, loss_fn: Callable) -> Callable:
    params = list(model.parameters())

    def step(batch):
        final, (_, ups) = model(batch["image1"], batch["image2"], with_intermediate=True)
        loss = loss_fn(ups, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_(params, 1.0)
        opt.step()
        return loss.detach(), final.detach()

    return step


def make_raft_train_step(model: RAFT, opt) -> Callable:
    """``step(batch) -> {"loss", "epe"}``: the sequence loss against
    ``batch["flow"]``, the global-norm clip at 1, one ``opt`` step."""
    step = _train_step(model, opt, lambda ups, b: sequence_loss(ups, b["flow"]))

    def train_step(batch):
        loss, final = step(batch)
        epe = torch.linalg.vector_norm(final - batch["flow"], dim=1).mean()
        return {"loss": loss, "epe": epe}

    return train_step


def synthetic_flow_batch(rng: np.random.Generator, batch: int, size: int,
                         max_shift: float = 6.0, device="cpu") -> Dict[str, torch.Tensor]:
    """Random textured images under random global translations, with their
    ground-truth flow, as (B, C, size, size) tensors on ``device``."""
    import cv2

    imgs1, imgs2, flows = [], [], []
    for _ in range(batch):
        base = rng.normal(size=(size * 2, size * 2, 3)).astype(np.float32)
        base = cv2.GaussianBlur(base, (0, 0), 3.0)
        base = (base - base.min()) / (np.ptp(base) + 1e-6) * 2 - 1
        dx, dy = rng.uniform(-max_shift, max_shift, size=2)
        q = size // 2
        M = np.float32([[1, 0, -dx], [0, 1, -dy]])
        shifted = cv2.warpAffine(base, M, (size * 2, size * 2))
        imgs1.append(base[q: q + size, q: q + size])
        imgs2.append(shifted[q: q + size, q: q + size])
        flows.append(np.full((size, size, 2), (dx, dy), np.float32))
    return {k: torch.from_numpy(np.stack(v).transpose(0, 3, 1, 2)).to(device)
            for k, v in (("image1", imgs1), ("image2", imgs2), ("flow", flows))}


SYNTHETIC_CFG = RAFTConfig(base=32, feature_dim=96, hidden_dim=64, context_dim=64,
                           corr_levels=2, corr_radius=3, iters=4)


def train_raft_synthetic(steps: int = 400, size: int = 32, batch: int = 8,
                         lr: float = 1e-3, seed: int = 0,
                         cfg: Optional[RAFTConfig] = None, log_every: int = 50,
                         device="cuda"):
    """From-scratch training on synthetic translations (``max_shift`` 4);
    returns (model, last EPE)."""
    model = init_raft(cfg or SYNTHETIC_CFG, seed, device)
    step = make_raft_train_step(model, make_optimizer(model, lr))
    rng = np.random.default_rng(seed)
    log = {}
    for i in range(steps):
        log = step(synthetic_flow_batch(rng, batch, size, 4.0, device))
        if log_every and (i + 1) % log_every == 0:
            print(f"raft step {i + 1}: loss={float(log['loss']):.3f} "
                  f"epe={float(log['epe']):.3f}")
    return model, float(log["epe"])


def warp_image(img, flow):
    """Backward warp: out(x) = img(x + flow(x)); img (B, C, H, W), flow
    (B, 2, H, W)."""
    B, C, H, W = img.shape
    coords = _coords_grid(B, H, W, flow.device, flow.dtype) + flow
    return bilinear_sample(img, coords.reshape(B, 2, H * W).transpose(1, 2)).reshape(
        B, C, H, W)


def _charbonnier(x, eps: float = 1e-3):
    return torch.sqrt(x * x + eps * eps)


def photometric_selfsup_loss(flow_preds_up, image1, image2, gamma: float = 0.8,
                             smooth_weight: float = 0.1, edge_scale: float = 10.0):
    """Exponentially weighted self-supervised loss over the iterations'
    flows (n, B, 2, H, W): the charbonnier error of image1 warped by the
    flow against image2 over the in-bounds samples, plus first-order
    smoothness damped at image2's edges."""
    n = flow_preds_up.shape[0]
    B, C, H, W = image1.shape
    base = _coords_grid(B, H, W, image1.device, image1.dtype)
    idx = (image2[..., 1:] - image2[..., :-1]).abs().mean(dim=1, keepdim=True)
    idy = (image2[:, :, 1:] - image2[:, :, :-1]).abs().mean(dim=1, keepdim=True)
    total = 0.0
    for i, flow in enumerate(flow_preds_up):
        coords = base + flow
        inb = ((coords[:, 0] >= 0) & (coords[:, 0] <= W - 1)
               & (coords[:, 1] >= 0) & (coords[:, 1] <= H - 1))[:, None].to(image1.dtype)
        photo = (_charbonnier(warp_image(image1, flow) - image2) * inb).sum() / (
            inb.sum() * C + 1e-6)
        fdx = flow[..., 1:] - flow[..., :-1]
        fdy = flow[:, :, 1:] - flow[:, :, :-1]
        smooth = ((fdx.abs() * torch.exp(-edge_scale * idx)).mean()
                  + (fdy.abs() * torch.exp(-edge_scale * idy)).mean())
        total = total + gamma ** (n - 1 - i) * (photo + smooth_weight * smooth)
    return total


def make_raft_selfsup_step(model: RAFT, opt, gamma: float = 0.8,
                           smooth_weight: float = 0.1) -> Callable:
    """Label-free ``step(batch) -> {"loss", "final"}`` on image pairs."""
    step = _train_step(model, opt, lambda ups, b: photometric_selfsup_loss(
        ups, b["image1"], b["image2"], gamma, smooth_weight))

    def train_step(batch):
        loss, final = step(batch)
        return {"loss": loss, "final": final}

    return train_step


def finetune_raft_selfsup(model: RAFT, batches, steps: int = 200, lr: float = 2e-4,
                          smooth_weight: float = 0.1, log_every: int = 0):
    """Fine-tune ``model`` in place on ``{"image1", "image2"}`` batches (an
    iterable, or a callable ``step -> batch``), AdamW with the global-norm
    clip; returns the last step's log."""
    step = make_raft_selfsup_step(model, make_optimizer(model, lr),
                                  smooth_weight=smooth_weight)
    get = batches if callable(batches) else (lambda i, _it=iter(batches): next(_it))
    log = {}
    for i in range(steps):
        log = step(get(i))
        if log_every and (i + 1) % log_every == 0:
            print(f"raft selfsup step {i + 1}: loss={float(log['loss']):.4f}")
    return log


# ---------------------------------------------------------------------------
# Official weights, the prep estimator
# ---------------------------------------------------------------------------


def load_torch_raft_npz(path: str, cfg: Optional[RAFTConfig] = None, device="cpu") -> RAFT:
    """An npz of an official RAFT ``state_dict`` as the port's net on
    ``device``: the DataParallel ``module.`` prefix and BatchNorm's
    ``num_batches_tracked`` dropped, a projection norm given under one of
    its two official names (``norm3``, ``downsample.1``) copied to the
    other, then a strict ``load_state_dict``."""
    raw = np.load(path)
    state = {k[len("module."):] if k.startswith("module.") else k: raw[k]
             for k in raw.files if not k.endswith("num_batches_tracked")}
    for k in list(state):
        for a, b in ((".norm3.", ".downsample.1."), (".downsample.1.", ".norm3.")):
            if a in k:
                state.setdefault(k.replace(a, b), state[k])
    net = RAFT(cfg)
    net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    return net.to(device)


_RAFT_CACHE: dict = {}


def raft_estimator(img1: np.ndarray, img2: np.ndarray, device="cuda") -> np.ndarray:
    """The prep flow estimator: a uint8 RGB (H, W, 3) pair -> float32 flow
    (2, H, W), computed on ``device``.  The net is ``IPOKE_RAFT_WEIGHTS``'
    npz when set, else the fixed-seed ``init_raft``; it is kept per (device,
    weights), for every frame size.  The frames are edge-padded to a
    multiple of 8 and the flow cropped back."""
    H, W = img1.shape[:2]
    ph, pw = (-H) % 8, (-W) % 8
    device = torch.device(device)
    wpath = os.environ.get("IPOKE_RAFT_WEIGHTS")
    key = (str(device), wpath)
    if key not in _RAFT_CACHE:
        net = load_torch_raft_npz(wpath) if wpath else init_raft()
        _RAFT_CACHE[key] = net.to(device).eval().requires_grad_(False)
    net = _RAFT_CACHE[key]

    def prep(im):
        x = np.pad(im.astype(np.float32) / 127.5 - 1.0, ((0, ph), (0, pw), (0, 0)),
                   mode="edge")
        return torch.from_numpy(x.transpose(2, 0, 1)[None]).to(device)

    with torch.no_grad():
        flow = net(prep(img1), prep(img2))
    return flow[0, :, :H, :W].cpu().numpy().astype(np.float32)
