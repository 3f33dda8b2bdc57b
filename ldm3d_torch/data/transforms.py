"""Volume transforms with reference parity, on the host (numpy) and on the
tensor's device (torch).

The port's own copies of ``val_patch_size``, ``center_crop_np``,
``random_crop_pair_np``, ``scale_intensity_percentiles_np`` and
``scale_intensity_percentiles`` from ``ldm3d_tpu/data/transforms.py``
(reference ``3d_ldm/utils.py:86-107``: ``CenterSpatialCropd``,
``RandSpatialCropd`` and ``ScaleIntensityRangePercentilesd(lower=0,
upper=99.5, b_min=0, b_max=1)``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["val_patch_size", "center_crop_np", "random_crop_pair_np",
           "scale_intensity_percentiles_np", "scale_intensity_percentiles"]


def val_patch_size(patch_size: Sequence[int], size_divisible: int, randcrop: bool) -> list[int]:
    """Validation crop: 1.5x the train patch rounded up to divisibility when
    random cropping, else the patch itself (reference ``utils.py:88-91``)."""
    if randcrop:
        return [int(math.ceil(1.5 * p / size_divisible) * size_divisible) for p in patch_size]
    return list(patch_size)


def center_crop_np(vol: np.ndarray, roi: Sequence[int]) -> np.ndarray:
    """Center-crop a (D, H, W, C) or (D, H, W) volume; clamps roi to volume."""
    spatial = vol.shape[:3]
    roi = [min(r, s) for r, s in zip(roi, spatial)]
    start = [max(0, (s - r) // 2) for s, r in zip(spatial, roi)]
    sl = tuple(slice(st, st + r) for st, r in zip(start, roi))
    return vol[sl]


def random_crop_pair_np(image: np.ndarray, label: np.ndarray, roi: Sequence[int],
                        rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """One random crop applied to both members of the pair."""
    spatial = image.shape[:3]
    roi = [min(r, s) for r, s in zip(roi, spatial)]
    start = [int(rng.integers(0, s - r + 1)) for s, r in zip(spatial, roi)]
    sl = tuple(slice(st, st + r) for st, r in zip(start, roi))
    return image[sl], label[sl]


def scale_intensity_percentiles_np(
    vol: np.ndarray, lower: float = 0.0, upper: float = 99.5, b_min: float = 0.0, b_max: float = 1.0
) -> np.ndarray:
    a_min = np.percentile(vol, lower)
    a_max = np.percentile(vol, upper)
    denom = max(a_max - a_min, 1e-8)
    return ((vol - a_min) / denom * (b_max - b_min) + b_min).astype(np.float32)


def _percentile_of_sorted(rows: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(..., method="linear")`` of each row of ``rows``
    (sorted along dim 1), with the fp32 index arithmetic that XLA compiles
    it to: ``q / 100 * (n - 1)`` folded into ``q * (fp32(1 / 100) * (n - 1))``
    (the two orders pick weights up to 2e-4 apart), floor and ceil clamped to
    the row, the two neighbours weighted by the position's fraction."""
    n = rows.shape[1]
    f32 = np.float32
    pos = f32(q) * f32(f32(f32(1) / f32(100)) * f32(n - 1))
    low, high = np.floor(pos), np.ceil(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(1) - high_w
    lo = int(min(max(low, 0), n - 1))
    hi = int(min(max(high, 0), n - 1))
    return rows[:, lo] * float(low_w) + rows[:, hi] * float(high_w)


def scale_intensity_percentiles(vol: torch.Tensor, lower: float = 0.0, upper: float = 99.5,
                                b_min: float = 0.0, b_max: float = 1.0) -> torch.Tensor:
    """Per-sample percentile window scaling on the tensor's device, batched
    over axis 0.

    ``vol``: (B, D, H, W, C). Percentiles are computed per sample over all
    spatial dims and channels, matching MONAI's per-volume behaviour. Each
    sample is sorted once (``torch.quantile`` refuses rows of more than 2^24
    elements and takes its index in another precision than JAX's)."""
    x = vol.to(torch.float32)
    rows = torch.sort(x.reshape(x.shape[0], -1), dim=1).values
    shape = (-1,) + (1,) * (x.ndim - 1)
    a_min = _percentile_of_sorted(rows, lower).reshape(shape)
    a_max = _percentile_of_sorted(rows, upper).reshape(shape)
    denom = torch.clamp(a_max - a_min, min=1e-8)
    return (x - a_min) / denom * (b_max - b_min) + b_min
