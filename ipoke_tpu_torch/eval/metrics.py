"""Evaluation metrics (counterpart of ``ipoke_tpu/eval/metrics.py``): PSNR,
SSIM, the VGG perceptual distance, the optical-flow errors and their
threshold fractions (reference utils/metrics.py:20-83), the Fréchet
distances (FVD over the backbone of ``eval.backbone``, FID over pooled
VGG19 features) with the host-side moments and scipy ``sqrtm`` of the JAX
package, and the diversity scores of ``--test diversity`` (reference
``compute_div_score*``, metrics.py:139-212).  Images are NHWC in [-1, 1];
flow maps (..., 2)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Image metrics
# ---------------------------------------------------------------------------


def psnr(a, b, data_range: float = 2.0):
    """Per-image PSNR."""
    mse = ((a - b) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-10))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None):
    g = torch.exp(-0.5 * ((torch.arange(size, device=device, dtype=torch.float32)
                           - size // 2) / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a, b, data_range: float = 2.0):
    """Per-image SSIM with the 11x11 Gaussian window (valid region),
    variances clamped at 0."""
    c = a.shape[-1]
    kern = _gaussian_kernel(device=a.device).to(a.dtype)
    kern = kern[None, None].expand(c, 1, -1, -1)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kern, groups=c)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = filt(a), filt(b)
    va = torch.clamp(filt(a * a) - mu_a ** 2, min=0.0)
    vb = torch.clamp(filt(b * b) - mu_b ** 2, min=0.0)
    vab = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * vab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return s.mean(dim=(-3, -2, -1))


def perceptual_distance(vgg, a, b):
    """LPIPS-style distance over unit-normalised VGG19 features, mean over
    the five taps (uniform channel weights)."""
    total = 0.0
    fa, fb = vgg(a), vgg(b)
    for x, y in zip(fa, fb):
        xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-10)
        yn = y / (torch.linalg.norm(y, dim=-1, keepdim=True) + 1e-10)
        total = total + ((xn - yn) ** 2).mean(dim=(-3, -2, -1))
    return total / len(fa)


# ---------------------------------------------------------------------------
# Optical flow errors
# ---------------------------------------------------------------------------


def angular_error(f1, f2):
    """The angle between flow vectors extended with a unit third
    component."""
    ones = f1.new_ones((*f1.shape[:-1], 1))
    a, b = torch.cat([f1, ones], dim=-1), torch.cat([f2, ones], dim=-1)
    cos = (a * b).sum(dim=-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def endpoint_error(f1, f2):
    return (f1 - f2).norm(dim=-1)


def optical_flow_metrics(f1, f2):
    """Fractions of pixels above the angular (5/10/15 degrees) and endpoint
    (1/2/3/5 px) thresholds (reference ``optical_flow_metric``)."""
    ae, ee = angular_error(f1, f2), endpoint_error(f1, f2)
    out = {}
    for deg in (5.0, 10.0, 15.0):
        out[f"AE_R{deg:g}"] = (ae > deg * np.pi / 180.0).float().mean()
    for px in (1.0, 2.0, 3.0, 5.0):
        out[f"EE_R{px:g}"] = (ee > px).float().mean()
    return out


# ---------------------------------------------------------------------------
# Fréchet distances (FVD / FID)
# ---------------------------------------------------------------------------


def calculate_moments(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and covariance of the activation matrix; a diagonal covariance
    when N < D (the full one is rank-deficient there)."""
    mu = np.mean(acts, axis=0)
    n, d = acts.shape
    if n < d:
        sigma = np.diag(np.var(acts, axis=0, ddof=1) + 1e-8)
    else:
        sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Stable Fréchet distance (reference metrics.py:690-743)."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
        - 2.0 * np.trace(covmean)
    )


@torch.no_grad()
def compute_fid(vgg, real_images, fake_images, batch_size: int = 32) -> float:
    """Fréchet distance over VGG19's last tap, mean-pooled (the JAX
    package's stand-in for the reference's InceptionV3 FID)."""
    dev = next(vgg.parameters()).device

    def collect(images):
        out = []
        for i in range(0, images.shape[0], batch_size):
            x = torch.as_tensor(images[i:i + batch_size]).to(dev, torch.float32)
            out.append(vgg(x)[-1].mean(dim=(1, 2)).cpu().numpy())
        return np.concatenate(out)

    a, b = collect(real_images), collect(fake_images)
    return frechet_distance(*calculate_moments(a), *calculate_moments(b))


def compute_fvd(backbone, real_videos, fake_videos, batch_size: int = 8) -> float:
    """FVD over the backbone's activations (``eval.backbone``); videos (N,
    T, H, W, 3) in [-1, 1], tensors or arrays."""
    from .backbone import backbone_activations

    a_real = backbone_activations(backbone, real_videos, batch_size)
    a_fake = backbone_activations(backbone, fake_videos, batch_size)
    return frechet_distance(*calculate_moments(a_real),
                            *calculate_moments(a_fake))


# ---------------------------------------------------------------------------
# Diversity: samples (N, S, T, H, W, 3) in [-1, 1], S samples of each of N
# data points, host arrays
# ---------------------------------------------------------------------------


def diversity_score_mse(samples) -> float:
    """Mean over sample pairs of the MSE between them."""
    samples = np.asarray(samples)
    s = samples.shape[1]
    total, cnt = 0.0, 0
    for i in range(s):
        for j in range(i + 1, s):
            total += float(np.mean((samples[:, i] - samples[:, j]) ** 2))
            cnt += 1
    return total / max(cnt, 1)


@torch.no_grad()
def diversity_score_lpips(lpips, samples) -> float:
    """Mean over sample pairs of the per-frame LPIPS (reference
    ``compute_div_score_lpips``).  One feature pass per sample and chunk of
    ``max(1, 256 // N)`` frames of every data point, as the JAX package
    chunks, so that only S chunk-sized feature stacks are held at once."""
    dev = next(lpips.parameters()).device
    samples = np.asarray(samples)
    n, s = samples.shape[:2]
    frame = samples.shape[3:]
    frames = samples.reshape(n, s, -1, *frame)
    n_frames = frames.shape[2]
    chunk = max(1, 256 // max(n, 1))
    pair_sums = np.zeros((s, s))
    count = 0
    for f0 in range(0, n_frames, chunk):
        f1 = min(f0 + chunk, n_frames)
        feats = [lpips.features(torch.as_tensor(
            frames[:, i, f0:f1].reshape(-1, *frame)).to(dev, torch.float32))
            for i in range(s)]
        for i in range(s):
            for j in range(i + 1, s):
                pair_sums[i, j] += float(lpips.from_features(feats[i], feats[j]).sum())
        count += (f1 - f0) * n
    total, cnt = 0.0, 0
    for i in range(s):
        for j in range(i + 1, s):
            total += pair_sums[i, j] / max(count, 1)
            cnt += 1
    return total / max(cnt, 1)


@torch.no_grad()
def diversity_score_vgg(vgg, samples) -> float:
    """Mean over sample pairs of the cosine distance between VGG19 last-tap
    features (unit-normalised, eps 1e-10), frame by frame (reference
    ``compute_div_score``)."""
    dev = next(vgg.parameters()).device
    samples = np.asarray(samples)
    s = samples.shape[1]

    def feats(i):
        x = torch.as_tensor(samples[:, i].reshape(-1, *samples.shape[3:]))
        f = vgg(x.to(dev, torch.float32))[-1].reshape(x.shape[0], -1)
        return f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-10)

    fs = [feats(i) for i in range(s)]
    total, cnt = 0.0, 0
    for i in range(s):
        for j in range(i + 1, s):
            total += float((1.0 - (fs[i] * fs[j]).sum(dim=-1)).mean())
            cnt += 1
    return total / max(cnt, 1)
