"""Slice visualisation for TensorBoard: the port's copy of
``visualize_one_slice_in_3d_image`` from ``ldm3d_tpu/obs/visualize.py``
(reference ``3d_ldm/visualize_image.py:32-76``): the centre slice per axis
(axis 2 at centre - 10), min-max normalised to [0, 1], as ``(1, H, W)``."""

from __future__ import annotations

import numpy as np

__all__ = ["visualize_one_slice_in_3d_image"]


def visualize_one_slice_in_3d_image(image, axis: int = 2):
    """Return a (1, H, W) float array in [0, 1] for TB, or None on bad input."""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim != 3 or axis not in (0, 1, 2):
        return None
    center = img.shape[axis] // 2
    if axis == 0:
        draw = img[center, :, :]
    elif axis == 1:
        draw = img[:, center, :]
    else:
        draw = img[:, :, max(0, center - 10)]
    if draw.min() < 0:
        draw = draw - draw.min()
    if draw.max() > 0:
        draw = draw / draw.max()
    return draw[None, ...]
