"""Synthetic paired low/high-count volume generator.

The port's own copy of ``make_pair`` from ``ldm3d_tpu/data/synthetic.py``:
smooth blob mixtures resembling PET/MRI count maps; ``high`` is the clean
volume, ``low`` a Poisson-thinned version of it. The same seeded
``np.random.Generator`` gives the same volumes as the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["make_pair"]


def _blob_volume(rng: np.random.Generator, shape: Sequence[int], n_blobs: int = 6) -> np.ndarray:
    d, h, w = shape
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij"
    )
    vol = np.zeros(shape, np.float32)
    for _ in range(n_blobs):
        c = rng.uniform(-0.6, 0.6, size=3)
        s = rng.uniform(0.08, 0.35, size=3)
        a = rng.uniform(0.3, 1.0)
        vol += a * np.exp(-(((zz - c[0]) / s[0]) ** 2 + ((yy - c[1]) / s[1]) ** 2 + ((xx - c[2]) / s[2]) ** 2))
    return vol.astype(np.float32)


def make_pair(rng: np.random.Generator, shape: Sequence[int], counts: float = 50.0) -> np.ndarray:
    """Return a ``(2, D, H, W)`` array: [low-count, high-count]."""
    high = _blob_volume(rng, shape)
    high = high / max(high.max(), 1e-6)
    lam = np.clip(high, 0, None) * counts
    low = rng.poisson(lam).astype(np.float32) / counts
    return np.stack([low, high], axis=0)
