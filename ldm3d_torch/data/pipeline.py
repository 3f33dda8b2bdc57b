"""``prepare_dataloader``, the data entry point, and the inference CLI's
conditioning volumes.

The port of ``ldm3d_tpu/data/pipeline.py``: train and validation loaders
from the merged args (explicit train/val NPZ dirs, or one dir split by a
seeded shuffle with ``val_fraction``), random- or center-cropped train
patches, 1.5x-rounded center-cropped validation patches when random
cropping, percentile intensity scaling. With ``synthetic_data`` and no NPZ
dirs, the JAX package writes seeded synthetic pairs to a temporary directory
first; here the same pairs are made in memory from the same seed, so both
packages see the same volumes.

The JAX inference CLI takes the first batch of its validation loader
(``randcrop=False``); :func:`val_condition_volumes` returns the same volumes
without building the training split.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Any, Optional, Sequence

import numpy as np

from ldm3d_torch.data.loader import BatchLoader
from ldm3d_torch.data.npz_dataset import NPZPairDataset, load_pair
from ldm3d_torch.data.synthetic import make_pair
from ldm3d_torch.data.transforms import (
    center_crop_np,
    scale_intensity_percentiles_np,
    val_patch_size,
)

__all__ = ["build_file_lists", "prepare_dataloader", "val_condition_volumes"]


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


class _DataArgs:
    """The data keys of the merged args, with the JAX package's defaults."""

    def __init__(self, args: Any, patch_size: Sequence[int]):
        self.npz_dir_train = getattr(args, "npz_dir_train", None) or None
        self.npz_dir_val = getattr(args, "npz_dir_val", None) or None
        self.npz_dir = getattr(args, "npz_dir", None) or None
        self.val_fraction = float(getattr(args, "val_fraction", 0.1))
        self.seed = int(getattr(args, "seed", 0))
        has_dirs = bool((self.npz_dir_train and self.npz_dir_val) or self.npz_dir)
        if getattr(args, "synthetic_data", False) and (self.npz_dir_train or self.npz_dir_val) \
                and not has_dirs:
            raise ValueError("synthetic_data=true but a real-data directory is partially "
                             "configured (set BOTH npz_dir_train and npz_dir_val, or npz_dir, "
                             "or neither)")
        self.synthetic = bool(getattr(args, "synthetic_data", False)) and not has_dirs
        self.synthetic_num = int(getattr(args, "synthetic_num", 16))
        self.synthetic_shape = tuple(getattr(args, "synthetic_shape", None)
                                     or [max(64, p) for p in patch_size])

    def synthetic_pairs(self, count: int) -> list[np.ndarray]:
        """The first ``count`` seeded synthetic pairs (the JAX package's files)."""
        rng = np.random.default_rng(self.seed)
        return [make_pair(rng, self.synthetic_shape) for _ in range(count)]

    def sources(self) -> tuple[list, list]:
        """(train, val) sources: NPZ paths, or the synthetic pairs in memory."""
        if self.synthetic:
            pairs = self.synthetic_pairs(self.synthetic_num)
            train_idx, val_idx = _split(self.synthetic_num, self.val_fraction, self.seed)
            return [pairs[i] for i in train_idx], [pairs[i] for i in val_idx]
        return build_file_lists(self.npz_dir_train, self.npz_dir_val, self.npz_dir,
                                self.val_fraction, self.seed)


def prepare_dataloader(args: Any, batch_size: int, patch_size: Sequence[int],
                       randcrop: bool = True, size_divisible: int = 16,
                       scale_on_host: bool = True) -> tuple[BatchLoader, BatchLoader]:
    """``(train, val)`` loaders: shuffled drop-last train batches, in-order
    validation batches with a partial batch padded by its last sample."""
    data = _DataArgs(args, patch_size)
    train_sources, val_sources = data.sources()
    vps = val_patch_size(patch_size, size_divisible, randcrop)
    train_ds = NPZPairDataset(train_sources, patch_size=patch_size, randcrop=randcrop,
                              scale_on_host=scale_on_host, seed=data.seed)
    val_ds = NPZPairDataset(val_sources, patch_size=vps, randcrop=False,
                            scale_on_host=scale_on_host, seed=data.seed)
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                               seed=data.seed)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False, drop_last=True,
                             pad_partial=True, seed=data.seed)
    if train_loader.steps_per_epoch() == 0:
        raise ValueError(
            f"training set ({len(train_ds)} volumes) is smaller than the batch size "
            f"{batch_size}; add data, raise synthetic_num, or lower batch_size (drop_last "
            f"keeps the batch shape uniform)")
    return train_loader, val_loader


def val_condition_volumes(args: Any, batch: int, patch_size: Sequence[int]) -> np.ndarray:
    """``(batch, *patch_size, 1)`` fp32 low-count volumes, as the JAX CLI's
    first validation batch."""
    data = _DataArgs(args, patch_size)
    if data.synthetic:
        _, val_idx = _split(data.synthetic_num, data.val_fraction, data.seed)
        chosen = [int(i) for i in val_idx[:batch]]
        pairs = data.synthetic_pairs(max(chosen) + 1)
        lows = [pairs[i][0] for i in chosen]
    else:
        _, val_files = data.sources()
        lows = [load_pair(p)[0] for p in val_files[:batch]]
    lows += [lows[-1]] * (batch - len(lows))  # pad a partial batch with its last volume
    vols = [scale_intensity_percentiles_np(center_crop_np(low[..., None], patch_size))
            for low in lows]
    return np.stack(vols, axis=0)
