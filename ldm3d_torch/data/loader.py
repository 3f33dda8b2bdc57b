"""Host-side batch loader: seeded per-epoch shuffling, drop-last or padded
batching, and a background thread that prepares the next batches while the
device computes.

The port's copy of ``BatchLoader`` from ``ldm3d_tpu/data/loader.py`` for one
process: ``device_prefetch`` and the multi-host shard of the loader wait for
ROADMAP.md queue A, 'Stage-2 training follow-ups'.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

__all__ = ["BatchLoader"]


def _stack(samples: Sequence[dict]) -> dict:
    out = {}
    for k in samples[0].keys():
        arrs = [s[k] for s in samples]
        shapes = {a.shape for a in arrs}
        if len(shapes) > 1:
            raise ValueError(
                f"batch samples for '{k}' have mixed shapes {sorted(shapes)}: some source "
                "volumes are smaller than patch_size (crops clamp to the volume); "
                "resample/pad the data or lower patch_size")
        out[k] = np.stack(arrs, axis=0)
    return out


class BatchLoader:
    """Iterates epoch batches with prefetch; one instance per dataset split.

    ``drop_last`` keeps the batch shape uniform (reference ``utils.py:215``);
    ``pad_partial`` instead pads a trailing partial batch by repeating its last
    sample, for small validation sets."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2, pad_partial: bool = False):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last and not pad_partial
        self.pad_partial = pad_partial
        self.seed = seed
        self.prefetch = max(1, prefetch)

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield stacked numpy batches for one epoch, prepared on a thread."""
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(self.seed + epoch)
        indices = self._epoch_indices(epoch)
        nb = self.steps_per_epoch()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            """put() that gives up once the consumer has abandoned the epoch."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    chunk = indices[b * self.batch_size:(b + 1) * self.batch_size]
                    if self.pad_partial and len(chunk) < self.batch_size:
                        chunk = np.concatenate(
                            [chunk, np.full(self.batch_size - len(chunk), chunk[-1])])
                    if not put(_stack([self.dataset[int(i)] for i in chunk])):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            t.join()
            if err:
                raise err[0]
        finally:
            stop.set()
