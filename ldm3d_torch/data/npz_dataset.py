"""Paired low/high-count dataset with reference-parity semantics.

The port's copy of ``NPZPairDataset`` from ``ldm3d_tpu/data/npz_dataset.py``
(numpy path; the native loader is ROADMAP.md queue A, 'Data'): each source is an NPZ file
holding one ``(2, D, H, W)`` array under ``arr0``/``arr_0`` (or its first
key), index 0 the low-count "image", 1 the high-count "label", or that
``(2, D, H, W)`` array itself (the synthetic pairs, made in memory).
Samples are NDHWC.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ldm3d_torch.data.transforms import (
    center_crop_np,
    random_crop_pair_np,
    scale_intensity_percentiles_np,
)

__all__ = ["NPZPairDataset", "load_pair"]

Source = Union[str, np.ndarray]


def load_pair(source: Source) -> tuple[np.ndarray, np.ndarray]:
    """``(low, high)`` fp32 ``(D, H, W)`` volumes of one source."""
    if isinstance(source, np.ndarray):
        arr = source
    else:
        with np.load(source) as data:
            keys = list(data.keys())
            if not keys:
                raise RuntimeError(f"NPZ {source} is empty; expected 'arr0' or 'arr_0'")
            key = "arr0" if "arr0" in data else "arr_0" if "arr_0" in data else keys[0]
            arr = data[key]
    if arr.ndim < 4 or arr.shape[0] < 2:
        raise RuntimeError(f"pair {source if isinstance(source, str) else ''} expected shape "
                           f"(2, D, H, W), got {arr.shape}")
    return np.asarray(arr[0], dtype=np.float32), np.asarray(arr[1], dtype=np.float32)


class NPZPairDataset:
    """Map-style dataset yielding ``{"image": (D,H,W,1), "label": (D,H,W,1)}``
    fp32, center- or randomly cropped to ``patch_size`` and percentile-scaled."""

    def __init__(self, sources: Sequence[Source], patch_size: Optional[Sequence[int]] = None,
                 randcrop: bool = False, scale_on_host: bool = True, seed: int = 0):
        self.sources = list(sources)
        self.patch_size = list(patch_size) if patch_size is not None else None
        self.randcrop = randcrop
        self.scale_on_host = scale_on_host
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.sources)

    def set_epoch_seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        low, high = load_pair(self.sources[idx])
        low, high = low[..., None], high[..., None]  # channels-last
        if self.patch_size is not None:
            if self.randcrop:
                low, high = random_crop_pair_np(low, high, self.patch_size, self._rng)
            else:
                low = center_crop_np(low, self.patch_size)
                high = center_crop_np(high, self.patch_size)
        if self.scale_on_host:
            low = scale_intensity_percentiles_np(low)
            high = scale_intensity_percentiles_np(high)
        return {"image": low.astype(np.float32), "label": high.astype(np.float32)}
