"""Evaluation (counterpart of ``ipoke_tpu/eval``): the validation metrics
and the FVD backbone."""

from .backbone import init_fvd_backbone
from .metrics import (
    angular_error,
    calculate_moments,
    compute_fid,
    compute_fvd,
    endpoint_error,
    frechet_distance,
    perceptual_distance,
    psnr,
    ssim,
)
