"""Host-side (numpy) volume transforms with reference parity.

The port's own copies of ``center_crop_np`` and
``scale_intensity_percentiles_np`` from ``ldm3d_tpu/data/transforms.py``
(reference ``3d_ldm/utils.py:86-107``: ``CenterSpatialCropd`` and
``ScaleIntensityRangePercentilesd(lower=0, upper=99.5, b_min=0, b_max=1)``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["center_crop_np", "scale_intensity_percentiles_np"]


def center_crop_np(vol: np.ndarray, roi: Sequence[int]) -> np.ndarray:
    """Center-crop a (D, H, W, C) or (D, H, W) volume; clamps roi to volume."""
    spatial = vol.shape[:3]
    roi = [min(r, s) for r, s in zip(roi, spatial)]
    start = [max(0, (s - r) // 2) for s, r in zip(spatial, roi)]
    sl = tuple(slice(st, st + r) for st, r in zip(start, roi))
    return vol[sl]


def scale_intensity_percentiles_np(
    vol: np.ndarray, lower: float = 0.0, upper: float = 99.5, b_min: float = 0.0, b_max: float = 1.0
) -> np.ndarray:
    a_min = np.percentile(vol, lower)
    a_max = np.percentile(vol, upper)
    denom = max(a_max - a_min, 1e-8)
    return ((vol - a_min) / denom * (b_max - b_min) + b_min).astype(np.float32)
