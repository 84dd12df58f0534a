"""Evaluation (counterpart of ``ipoke_tpu/eval``): the metrics, the FVD
backbones (MotionFeatureNet, I3D) and the pose estimator."""

from .backbone import backbone_activations, init_fvd_backbone
from .i3d import I3D, i3d_activations, init_i3d, load_torch_i3d_npz
from .metrics import (
    angular_error,
    calculate_moments,
    compute_fid,
    compute_fvd,
    diversity_score_lpips,
    diversity_score_mse,
    diversity_score_vgg,
    endpoint_error,
    frechet_distance,
    optical_flow_metrics,
    perceptual_distance,
    psnr,
    ssim,
)
