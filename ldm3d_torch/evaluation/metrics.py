"""3-D image-quality metrics: MAE, MSE, PSNR, SSIM, MS-SSIM, Fréchet distance.

The port's own copy of ``ldm3d_tpu/evaluation/metrics.py``. Every paired
metric takes two ``(B, D, H, W, C)`` tensors (channels last) and returns the
``(B,)`` per-sample values, computed in fp32 on the tensors' device. Volumes
are taken to be intensity-scaled to ``[0, 1]``; ``data_range`` overrides.

The SSIM filter is a separable Gaussian: three depthwise ``F.conv3d`` passes
with VALID padding. SSIM, MS-SSIM and the evaluator's latent features run
with both ``allow_tf32`` flags False whatever the caller set (PyTorch's
default takes TF32 for fp32 convolutions on the card), so a metric on the
card is the metric on the CPU. :func:`frechet_distance` is host numpy in
float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ldm3d_torch.cli.common import tf32_flags

__all__ = ["mae", "mse", "psnr", "ssim3d", "ms_ssim3d", "max_msssim_levels",
           "frechet_distance", "gaussian_kernel1d"]


def _flat_reduce(x: torch.Tensor) -> torch.Tensor:
    """Mean over everything but the leading batch axis."""
    return torch.mean(x.reshape(x.shape[0], -1), dim=1)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample mean absolute error, shape ``(B,)``."""
    return _flat_reduce(torch.abs(pred.float() - target.float()))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error, shape ``(B,)``."""
    d = pred.float() - target.float()
    return _flat_reduce(d * d)


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-sample peak signal-to-noise ratio in dB, shape ``(B,)``; identical
    volumes give ``inf`` (kept: the evaluator applies its ceiling)."""
    return 10.0 * torch.log10((data_range * data_range) / mse(pred, target))


def gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalised 1-D Gaussian window (the SSIM standard 11 taps, sigma 1.5)."""
    half = (size - 1) / 2.0
    x = np.arange(size, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _filter3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable depthwise Gaussian filter along D, H and W of a
    ``(B, D, H, W, C)`` volume, VALID: three depthwise convolutions of one
    axis each (3k taps a voxel instead of k^3)."""
    c, k = x.shape[-1], kernel.shape[0]
    h = x.permute(0, 4, 1, 2, 3)
    for axis in range(3):
        shape = [1, 1, 1]
        shape[axis] = k
        h = F.conv3d(h, kernel.reshape(1, 1, *shape).expand(c, 1, *shape), groups=c)
    return h.permute(0, 2, 3, 4, 1)


def ssim3d(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
           window_size: int = 11, sigma: float = 1.5, return_cs: bool = False):
    """Per-sample 3-D SSIM of ``(B, D, H, W, C)`` volumes, shape ``(B,)``
    (with ``return_cs`` also the contrast-structure term): the Gaussian
    window applied separably, ``C1 = (0.01 L)^2``, ``C2 = (0.03 L)^2``, fp32.
    A window longer than the smallest spatial extent is clamped to it (kept
    odd), so thin volumes give a value and not the NaN of an empty map."""
    window_size = min(window_size, *pred.shape[1:4])
    window_size = window_size if window_size % 2 == 1 else window_size - 1
    with tf32_flags(False):
        x, y = pred.float(), target.float()
        kern = torch.from_numpy(gaussian_kernel1d(window_size, sigma)).to(x.device)
        mu_x = _filter3d(x, kern)
        mu_y = _filter3d(y, kern)
        mu_xx = mu_x * mu_x
        mu_yy = mu_y * mu_y
        mu_xy = mu_x * mu_y
        sigma_xx = _filter3d(x * x, kern) - mu_xx
        sigma_yy = _filter3d(y * y, kern) - mu_yy
        sigma_xy = _filter3d(x * y, kern) - mu_xy
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cs_map = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    if return_cs:
        return _flat_reduce(ssim_map), _flat_reduce(cs_map)
    return _flat_reduce(ssim_map)


# the standard MS-SSIM level weights (Wang et al. 2003), truncated and
# renormalised when the volume is too small for all five scales
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x average pool along D, H and W of a ``(B, D, H, W, C)`` volume."""
    return F.avg_pool3d(x.permute(0, 4, 1, 2, 3), 2).permute(0, 2, 3, 4, 1)


def max_msssim_levels(min_spatial: int, window_size: int = 11) -> int:
    """Largest level count whose coarsest scale still fits the window."""
    levels = 0
    size = min_spatial
    while size >= window_size and levels < 5:
        levels += 1
        size //= 2
    return max(levels, 1)


def ms_ssim3d(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
              window_size: int = 11, sigma: float = 1.5,
              levels: int | None = None) -> torch.Tensor:
    """Per-sample multi-scale SSIM, shape ``(B,)``: the product of the
    contrast-structure terms of the coarse scales and the SSIM of the last,
    each relu'd and raised to its weight. ``levels`` defaults to as many of
    the 5 standard scales as the volume supports; truncated weights are
    renormalised to sum to 1."""
    if levels is None:
        levels = max_msssim_levels(min(pred.shape[1:4]), window_size)
    weights = np.asarray(_MSSSIM_WEIGHTS[:levels], np.float32)
    weights = weights / weights.sum()
    x, y = pred.float(), target.float()
    vals = []
    for lvl in range(levels):
        s, cs = ssim3d(x, y, data_range=data_range, window_size=window_size, sigma=sigma,
                       return_cs=True)
        vals.append(s if lvl == levels - 1 else cs)
        if lvl != levels - 1:
            x, y = _avg_pool2(x), _avg_pool2(y)
    out = torch.ones_like(vals[0])
    for w, v in zip(weights, vals):
        out = out * torch.pow(torch.clamp(v, min=0.0), float(w))
    return out


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between Gaussians fit to two ``(N, F)`` feature sets:
    ``|mu_a - mu_b|^2 + tr(S_a + S_b - 2 (S_a^1/2 S_b S_a^1/2)^1/2)``, in
    float64 with symmetric-PSD square roots by eigendecomposition."""
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"need (N,F) feature arrays with equal F, got {a.shape} vs {b.shape}")
    mu_a, mu_b = a.mean(0), b.mean(0)
    cov_a = np.atleast_2d(np.cov(a, rowvar=False)) + eps * np.eye(a.shape[1])
    cov_b = np.atleast_2d(np.cov(b, rowvar=False)) + eps * np.eye(b.shape[1])

    def _sqrtm_psd(m: np.ndarray) -> np.ndarray:
        vals, vecs = np.linalg.eigh((m + m.T) / 2.0)
        return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T

    sa = _sqrtm_psd(cov_a)
    covmean = _sqrtm_psd(sa @ cov_b @ sa)
    diff = mu_a - mu_b
    d2 = float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2.0 * np.trace(covmean))
    return max(d2, 0.0)
