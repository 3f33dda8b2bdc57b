"""Latent caching for stage-2 training: encode the dataset once, train in
latent space.

The port of ``ldm3d_tpu/data/latent_cache.py``. Under data parallelism
each rank caches its contiguous ``1 / world`` of the dataset (the loader's
split) and yields ``batch / world`` samples a step. Stage 2 uses
center crops, so each sample's posterior is the same every epoch: the cache
holds every sample's posterior ``(mu, sigma)`` (fp32, host memory) and the
latents train step draws ``z = mu + sigma * eps`` afresh each step, the
semantics of ``encode_stage_2_inputs``.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator

import numpy as np
import torch

log = logging.getLogger("latent_cache")

__all__ = ["LatentCache"]


class LatentCache:
    """Precomputed posterior latents and an epoch iterator over them."""

    def __init__(self, label_mu, label_sigma, image_mu, image_sigma, batch_size: int,
                 seed: int = 0):
        self.label_mu = label_mu
        self.label_sigma = label_sigma
        self.image_mu = image_mu  # None for unconditional training
        self.image_sigma = image_sigma
        self.batch_size = batch_size
        self.seed = seed
        if batch_size <= 0 or len(label_mu) < batch_size:
            raise ValueError(f"cache of {len(label_mu)} samples cannot serve batch {batch_size}")

    @classmethod
    @torch.no_grad()
    def build(cls, ae, dataset, batch_size: int, device, encode_batch: int = 2,
              conditional: bool = True, seed: int = 0, num_hosts: int | None = None,
              host_id: int | None = None) -> "LatentCache":
        """Encode this rank's ``dataset[i]`` (``{"image", "label"}`` NDHWC
        numpy volumes, clipped to [0, 1]) through ``ae.encode`` on
        ``device``, in chunks of ``encode_batch``. ``batch_size`` is the
        global batch; ``num_hosts``/``host_id`` default to the data axis's
        size and this rank's index on it."""
        from ldm3d_torch.parallel.mesh import data_index, data_size

        if num_hosts is None:
            num_hosts, host_id = data_size(), data_index()
        elif num_hosts > 1 and host_id is None:
            raise ValueError("host_id is required when num_hosts > 1 is passed explicitly")
        host_id = host_id or 0
        if batch_size % num_hosts:
            raise ValueError(f"global batch {batch_size} not divisible by {num_hosts} hosts")

        def enc(volumes: list) -> tuple[np.ndarray, np.ndarray]:
            x = torch.from_numpy(np.clip(np.stack(volumes), 0, 1)).to(device)
            mu, sigma = ae.encode(x)
            return mu.float().cpu().numpy(), sigma.float().cpu().numpy()

        t0 = time.time()
        lm, ls, im, isg = [], [], [], []
        per_host = len(dataset) // num_hosts
        lo, hi = host_id * per_host, (host_id + 1) * per_host
        for start in range(lo, hi, encode_batch):
            samples = [dataset[i] for i in range(start, min(start + encode_batch, hi))]
            mu, sigma = enc([s["label"] for s in samples])
            lm.append(mu)
            ls.append(sigma)
            if conditional:
                mu, sigma = enc([s["image"] for s in samples])
                im.append(mu)
                isg.append(sigma)
        cache = cls(np.concatenate(lm), np.concatenate(ls),
                    np.concatenate(im) if conditional else None,
                    np.concatenate(isg) if conditional else None, batch_size // num_hosts, seed)
        log.info("cached %d samples' latents in %.1fs (%.1f MB host RAM)", len(cache),
                 time.time() - t0, cache.nbytes() / 1e6)
        return cache

    def nbytes(self) -> int:
        arrays = (self.label_mu, self.label_sigma, self.image_mu, self.image_sigma)
        return sum(a.nbytes for a in arrays if a is not None)

    def __len__(self) -> int:
        return len(self.label_mu)

    def steps_per_epoch(self) -> int:
        return len(self) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Shuffled latent batches (numpy), drop-last as the volume loader."""
        order = np.random.default_rng(self.seed + epoch).permutation(len(self))
        for b in range(self.steps_per_epoch()):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            out = {"label_mu": self.label_mu[sel], "label_sigma": self.label_sigma[sel]}
            if self.image_mu is not None:
                out["image_mu"] = self.image_mu[sel]
                out["image_sigma"] = self.image_sigma[sel]
            yield out
