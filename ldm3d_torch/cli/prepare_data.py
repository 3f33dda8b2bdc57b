"""Data preparation CLI: build the paired (2, D, H, W) NPZ dataset.

The port of ``ldm3d_tpu/cli/prepare_data.py``. The dataset contract is NPZ
files holding a ``(2, D, H, W)`` array, channel 0 the low-count ("image")
volume and channel 1 the high-count ("label") volume (reference
``3d_ldm/utils.py:116-159``). This CLI builds it from paired per-volume
files:

  * inputs: two directories (``--low-dir`` / ``--high-dir``) of ``.npy``,
    ``.npz``, ``.nii`` or ``.nii.gz`` volumes, paired by filename stem
    (NIfTI through the port's own ``utils.nifti.read_nifti``);
  * each pair must agree in shape, and is optionally center-cropped /
    zero-padded to ``--shape`` (all pairs must agree for uniform batch
    shapes downstream);
  * output: ``<out>/train/<stem>.npz`` and ``<out>/val/...`` under the
    ``arr0`` key, split by ``--val-fraction`` with a seeded shuffle.

Intensity scaling is not baked in: the loaders apply the reference's
``ScaleIntensityRangePercentiles(0, 99.5 -> [0, 1])`` at read time, so raw
intensities are kept here.

Usage: python -m ldm3d_torch.cli.prepare_data --low-dir L --high-dir H --out D
       [--shape 96 96 96] [--val-fraction 0.1] [--seed 0]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

from ldm3d_torch.utils.nifti import read_nifti

__all__ = ["VOLUME_EXTS", "load_volume", "fit_to_shape", "list_pairs", "prepare", "main"]

log = logging.getLogger("prepare_data")

VOLUME_EXTS = (".npy", ".npz", ".nii", ".nii.gz")


def _stem(name: str) -> str:
    for ext in sorted(VOLUME_EXTS, key=len, reverse=True):
        if name.endswith(ext):
            return name[: -len(ext)]
    return os.path.splitext(name)[0]


def load_volume(path: str) -> np.ndarray:
    """Load one 3-D volume from npy/npz/NIfTI; squeezes singleton channels."""
    if path.endswith(".npy"):
        vol = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as data:
            key = "arr0" if "arr0" in data else ("arr_0" if "arr_0" in data else list(data.keys())[0])
            vol = data[key]
    elif path.endswith((".nii", ".nii.gz")):
        vol, _ = read_nifti(path)
    else:
        raise ValueError(f"unsupported volume format: {path}")
    vol = np.squeeze(np.asarray(vol, np.float32))
    if vol.ndim != 3:
        raise ValueError(f"{path}: expected a 3-D volume, got shape {vol.shape}")
    return vol


def fit_to_shape(vol: np.ndarray, shape) -> np.ndarray:
    """Center-crop and/or zero-pad each axis to ``shape``."""
    out = vol
    for ax, target in enumerate(shape):
        size = out.shape[ax]
        if size > target:  # center crop
            start = (size - target) // 2
            out = np.take(out, np.arange(start, start + target), axis=ax)
        elif size < target:  # symmetric zero pad
            before = (target - size) // 2
            pad = [(0, 0)] * out.ndim
            pad[ax] = (before, target - size - before)
            out = np.pad(out, pad)
    return out


def list_pairs(low_dir: str, high_dir: str) -> list[tuple[str, str, str]]:
    """(stem, low_path, high_path) pairs matched by filename stem."""

    def index(d):
        return {_stem(name): os.path.join(d, name) for name in sorted(os.listdir(d))
                if name.endswith(VOLUME_EXTS)}

    low, high = index(low_dir), index(high_dir)
    common = sorted(set(low) & set(high))
    missing = sorted(set(low) ^ set(high))
    if missing:
        log.warning("skipping %d unpaired volumes (e.g. %s)", len(missing), missing[:4])
    if not common:
        raise FileNotFoundError(f"no filename-matched pairs between {low_dir} and {high_dir}")
    return [(s, low[s], high[s]) for s in common]


def prepare(low_dir: str, high_dir: str, out_dir: str, shape=None,
            val_fraction: float = 0.1, seed: int = 0) -> dict:
    """Write every pair's NPZ under ``out_dir``; returns the train/val counts."""
    pairs = list_pairs(low_dir, high_dir)
    order = np.random.default_rng(seed).permutation(len(pairs))
    n_val = (max(1, int(round(len(pairs) * val_fraction)))
             if val_fraction > 0 and len(pairs) > 1 else 0)
    val_set = set(order[:n_val].tolist())

    counts = {"train": 0, "val": 0}
    for i, (stem, lp, hp) in enumerate(pairs):
        low, high = load_volume(lp), load_volume(hp)
        if low.shape != high.shape:
            raise ValueError(f"pair '{stem}': low {low.shape} vs high {high.shape} shape mismatch")
        if shape is not None:
            low, high = fit_to_shape(low, shape), fit_to_shape(high, shape)
        arr = np.stack([low, high]).astype(np.float32)  # (2, D, H, W): image, label
        split = "val" if i in val_set else "train"
        dest = os.path.join(out_dir, split)
        os.makedirs(dest, exist_ok=True)
        np.savez(os.path.join(dest, f"{stem}.npz"), arr0=arr)
        counts[split] += 1
    log.info("wrote %d train / %d val pairs to %s", counts["train"], counts["val"], out_dir)
    return counts


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="build the paired (2,D,H,W) NPZ dataset")
    p.add_argument("--low-dir", required=True, help="directory of low-count ('image') volumes")
    p.add_argument("--high-dir", required=True, help="directory of high-count ('label') volumes")
    p.add_argument("--out", required=True, help="output dataset root (train/ and val/ created)")
    p.add_argument("--shape", type=int, nargs=3, default=None,
                   help="center-crop/pad every volume to D H W")
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout, force=True)
    counts = prepare(args.low_dir, args.high_dir, args.out, shape=args.shape,
                     val_fraction=args.val_fraction, seed=args.seed)
    print(f"done: {counts}")
    return counts


if __name__ == "__main__":
    main()
