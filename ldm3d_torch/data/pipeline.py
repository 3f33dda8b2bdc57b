"""The low-count conditioning volumes the inference CLI samples from.

The JAX CLI takes the first batch of its validation loader
(``ldm3d_tpu/data/pipeline.py::prepare_dataloader`` with ``randcrop=False``):
the validation split of the NPZ files (explicit train/val dirs, or one dir
split by a seeded shuffle with ``val_fraction``), in order, the last volume
repeated to fill a partial batch, each center-cropped to ``patch_size`` and
percentile-scaled. :func:`val_condition_volumes` returns the same volumes.
With ``synthetic_data`` and no NPZ dirs, the JAX package writes seeded
synthetic pairs to a temporary directory first; here the same pairs are made
in memory from the same seed.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Any, Optional, Sequence

import numpy as np

from ldm3d_torch.data.synthetic import make_pair
from ldm3d_torch.data.transforms import center_crop_np, scale_intensity_percentiles_np

__all__ = ["build_file_lists", "val_condition_volumes"]


def build_file_lists(npz_dir_train: Optional[str], npz_dir_val: Optional[str],
                     npz_dir: Optional[str], val_fraction: float = 0.1,
                     seed: int = 0) -> tuple[list[str], list[str]]:
    """Reference file-discovery/split logic (``3d_ldm/utils.py:162-184``)."""
    if npz_dir_train and npz_dir_val and os.path.isdir(npz_dir_train) and os.path.isdir(npz_dir_val):
        train_files = sorted(glob(os.path.join(npz_dir_train, "*.npz")))
        val_files = sorted(glob(os.path.join(npz_dir_val, "*.npz")))
        if not train_files:
            raise ValueError(f"no .npz files in train dir {npz_dir_train}")
        if not val_files:
            raise ValueError(f"no .npz files in val dir {npz_dir_val}")
        return train_files, val_files
    if not npz_dir or not os.path.isdir(npz_dir):
        raise ValueError("provide (npz_dir_train and npz_dir_val) or npz_dir")
    all_files = sorted(glob(os.path.join(npz_dir, "*.npz")))
    if not all_files:
        raise ValueError(f"no .npz files in {npz_dir}")
    train_idx, val_idx = _split(len(all_files), val_fraction, seed)
    return [all_files[i] for i in train_idx], [all_files[i] for i in val_idx]


def _split(n: int, val_fraction: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    n_val = int(n * val_fraction)
    return indices[n_val:], (indices[:n_val] if n_val > 0 else indices[:1])


def _load_low(path: str) -> np.ndarray:
    with np.load(path) as data:
        keys = list(data.keys())
        if not keys:
            raise RuntimeError(f"NPZ {path} is empty; expected 'arr0' or 'arr_0'")
        key = "arr0" if "arr0" in data else "arr_0" if "arr_0" in data else keys[0]
        arr = data[key]
    if arr.ndim < 4 or arr.shape[0] < 2:
        raise RuntimeError(f"NPZ {path} expected shape (2, D, H, W), got {arr.shape}")
    return np.asarray(arr[0], dtype=np.float32)


def val_condition_volumes(args: Any, batch: int, patch_size: Sequence[int]) -> np.ndarray:
    """``(batch, *patch_size, 1)`` fp32 low-count volumes, as the JAX CLI's
    first validation batch."""
    npz_dir_train = getattr(args, "npz_dir_train", None) or None
    npz_dir_val = getattr(args, "npz_dir_val", None) or None
    npz_dir = getattr(args, "npz_dir", None) or None
    val_fraction = float(getattr(args, "val_fraction", 0.1))
    seed = int(getattr(args, "seed", 0))
    synthetic = getattr(args, "synthetic_data", False)
    if synthetic and (npz_dir_train or npz_dir_val) and not (npz_dir_train and npz_dir_val) \
            and not npz_dir:
        raise ValueError("synthetic_data=true but a real-data directory is partially "
                         "configured (set BOTH npz_dir_train and npz_dir_val, or npz_dir, "
                         "or neither)")

    if synthetic and not (npz_dir_train and npz_dir_val) and not npz_dir:
        n = int(getattr(args, "synthetic_num", 16))
        shape = tuple(getattr(args, "synthetic_shape", None) or [max(64, p) for p in patch_size])
        _, val_idx = _split(n, val_fraction, seed)
        chosen = [int(i) for i in val_idx[:batch]]
        rng = np.random.default_rng(seed)
        pairs = [make_pair(rng, shape) for _ in range(max(chosen) + 1)]
        lows = [pairs[i][0] for i in chosen]
    else:
        _, val_files = build_file_lists(npz_dir_train, npz_dir_val, npz_dir, val_fraction, seed)
        lows = [_load_low(p) for p in val_files[:batch]]
    lows += [lows[-1]] * (batch - len(lows))  # pad a partial batch with its last volume
    vols = [scale_intensity_percentiles_np(center_crop_np(low[..., None], patch_size))
            for low in lows]
    return np.stack(vols, axis=0)
