"""Evaluation: 3-D image-quality metrics and the registration gate.

The port of ``ldm3d_tpu/evaluation``: SSIM, MS-SSIM, PSNR and MAE per
sample, a VAE-latent Fréchet distance, and the :class:`EvalReport` whose
composite score the evaluate CLI gates on.
"""

from ldm3d_torch.evaluation.evaluator import (
    EvalReport,
    composite_score,
    evaluate_pairs,
    latent_features,
)
from ldm3d_torch.evaluation.metrics import (
    frechet_distance,
    mae,
    ms_ssim3d,
    mse,
    psnr,
    ssim3d,
)

__all__ = ["EvalReport", "composite_score", "evaluate_pairs", "latent_features",
           "frechet_distance", "mae", "mse", "ms_ssim3d", "psnr", "ssim3d"]
