"""Host-side (numpy) volume transforms with reference parity.

The port's own copies of ``val_patch_size``, ``center_crop_np``,
``random_crop_pair_np`` and ``scale_intensity_percentiles_np`` from
``ldm3d_tpu/data/transforms.py`` (reference ``3d_ldm/utils.py:86-107``:
``CenterSpatialCropd``, ``RandSpatialCropd`` and
``ScaleIntensityRangePercentilesd(lower=0, upper=99.5, b_min=0, b_max=1)``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

__all__ = ["val_patch_size", "center_crop_np", "random_crop_pair_np",
           "scale_intensity_percentiles_np"]


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
