"""Host-side batch loader: seeded per-epoch shuffling, drop-last or padded
batching, and a background thread that prepares the next batches while the
device computes.

The port's copy of ``BatchLoader`` and ``device_prefetch`` from
``ldm3d_tpu/data/loader.py``. Under data parallelism each rank is a "host"
of the JAX arithmetic (``num_hosts`` = the world, ``host_id`` = the rank):
every rank shuffles with the same seed, takes its contiguous ``1 / world``
of the epoch's order, and yields ``batch / world`` samples a step; the
ranks' batches end to end are the JAX package's global batch.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections import deque
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

__all__ = ["BatchLoader", "device_prefetch"]


def device_prefetch(batches: Iterable[dict], size: int = 2, device="cuda") -> Iterator[dict]:
    """Keep ``size`` host batches in flight to ``device`` ahead of the
    consumer (``ldm3d_tpu/data/loader.py`` ``device_prefetch``; its mesh
    ``placement`` waits for the multi-host loader shard).

    On a CUDA device each array is pinned and copied ``non_blocking`` on a
    side stream, so batch i + 1's copy overlaps batch i's compute; before a
    batch is yielded the current stream waits for its copies (the event
    recorded after them on the side stream) and each tensor is marked used
    on the current stream (``record_stream``), so its memory is not reused
    while the consumer's kernels read it. On the CPU it is a plain
    ``to(device)``."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch: dict) -> tuple[dict, object]:
        if stream is None:
            return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.as_tensor(np.ascontiguousarray(v)).pin_memory().to(
                device, non_blocking=True) for k, v in batch.items()}
            return out, stream.record_event()

    it = iter(batches)
    buf: deque = deque(put(b) for b in itertools.islice(it, max(1, size)))
    while buf:
        nxt, copied = buf.popleft()
        for b in itertools.islice(it, 1):
            buf.append(put(b))
        if copied is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for t in nxt.values():
                t.record_stream(current)
        yield nxt


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

    ``batch_size`` is the GLOBAL batch; with ``num_hosts`` ranks each yields
    its ``batch_size / num_hosts`` share (JAX's ``ValueError`` when they do
    not divide it). ``drop_last`` keeps the batch shape uniform (reference
    ``utils.py:215``); ``pad_partial`` instead pads a trailing partial batch
    by repeating its last sample, for small validation sets."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2, num_hosts: int = 1, host_id: int = 0,
                 pad_partial: bool = False):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if batch_size % max(1, num_hosts):
            raise ValueError(f"global batch {batch_size} not divisible by {num_hosts} hosts")
        self.dataset = dataset
        self.batch_size = batch_size // max(1, num_hosts)
        self.shuffle = shuffle
        self.drop_last = drop_last and not pad_partial
        self.pad_partial = pad_partial
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.num_hosts = max(1, num_hosts)
        self.host_id = host_id

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.num_hosts
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        # this rank's contiguous share, DistributedSampler-style
        per_host = len(idx) // self.num_hosts
        if per_host == 0:
            raise ValueError("dataset smaller than host count")
        return idx[self.host_id * per_host:(self.host_id + 1) * per_host]

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield stacked numpy batches for one epoch, prepared on a thread."""
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(self.seed + epoch)
        indices = self._epoch_indices(epoch)
        nb = (len(indices) // self.batch_size if self.drop_last
              else -(-len(indices) // self.batch_size))
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
