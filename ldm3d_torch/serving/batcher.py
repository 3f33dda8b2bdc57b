"""Dynamic micro-batching for the serving sampler.

The port's own copy of ``ldm3d_tpu/serving/batcher.py`` (pure Python). The
sampler runs at a fixed batch size ``B``, but HTTP requests arrive one volume
at a time. Concurrent requests are merged: a worker thread collects submitted
samples for up to ``max_wait_ms`` (or until ``B`` are queued), pads the final
partial group with copies of its last sample, runs ONE sampler call, and
distributes the per-sample slices.

Sample independence makes this exact on the CPU: convolutions, attention and
GroupNorm never mix batch entries, and the call's batch size is always ``B``,
so a volume's value is the same in any batch composition
(``tests/test_torch_serving_batcher.py``). On the card, ``chip_smoke.py``
measures the difference and holds it to a stated limit.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

log = logging.getLogger("batcher")

__all__ = ["DynamicBatcher"]


class _Item:
    __slots__ = ("noise", "cond", "rng_seed", "event", "result", "error")

    def __init__(self, noise, cond, rng_seed):
        self.noise = noise
        self.cond = cond
        self.rng_seed = rng_seed
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Merge single-sample submissions into fixed-size batched sampler calls.

    Args:
      run_batch: ``(noise[B,...], rng_seed:int, cond[B,...]|None) -> vols[B,...]``
        — the sampler call (one fixed batch size).
      batch_size: the sampler's batch ``B``.
      max_wait_ms: how long the worker waits to fill a batch after the first
        sample arrives. 0 = never wait (each call takes whatever is queued).
    """

    def __init__(self, run_batch: Callable[..., Any], batch_size: int,
                 max_wait_ms: float = 10.0):
        self.run_batch = run_batch
        self.batch_size = max(1, int(batch_size))
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Item]" = queue.Queue()
        self._closed = threading.Event()
        self.batches_run = 0
        self.samples_run = 0
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="sampler-batcher")
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, noise, cond=None, rng_seed: int = 0, timeout: Optional[float] = None):
        """Submit ONE sample (no batch dim); blocks until its volume is ready."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        item = _Item(noise, cond, rng_seed)
        self._q.put(item)
        if self._closed.is_set():
            # raced a concurrent close(): once _closed is set the worker never
            # STARTS a new batch (it may still be finishing one — close()'s
            # 5 s join can expire mid-sampling — so don't gate on is_alive(),
            # or this item waits out the caller's full timeout instead of
            # failing fast)
            self._fail_stranded()
        if not item.event.wait(timeout):
            raise TimeoutError("sample did not complete in time")
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        self._closed.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=5)
        self._fail_stranded()

    def _fail_stranded(self) -> None:
        """Fail anything stranded in the queue (e.g. a submit that raced the
        close, as in a /generate concurrent with /model/reload) so no request
        thread blocks forever on a dead worker."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.error = RuntimeError("batcher closed during request")
                item.event.set()

    # -- worker side ---------------------------------------------------------

    def _collect(self) -> list:
        """Block for the first item, then fill the batch within the window."""
        first = self._q.get()
        if first is None:
            return []
        group = [first]
        deadline = time.monotonic() + self.max_wait
        while len(group) < self.batch_size:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._q.get(timeout=remaining) if remaining > 0
                       else self._q.get_nowait())
            except queue.Empty:
                break
            if nxt is None:
                break
            group.append(nxt)
        return group

    def _loop(self) -> None:
        while not self._closed.is_set():
            group = self._collect()
            if not group:
                continue
            try:
                n = len(group)
                pad = self.batch_size - n
                noise = np.stack([np.asarray(i.noise) for i in group]
                                 + [np.asarray(group[-1].noise)] * pad)
                cond = None
                if group[0].cond is not None:
                    cond = np.stack([np.asarray(i.cond) for i in group]
                                    + [np.asarray(group[-1].cond)] * pad)
                vols = np.asarray(self.run_batch(noise, group[0].rng_seed, cond))
                self.batches_run += 1
                self.samples_run += n
                for i, item in enumerate(group):
                    item.result = vols[i]
                    item.event.set()
            except BaseException as e:  # noqa: BLE001 — surfaced to every waiter
                log.exception("batched sampler call failed")
                for item in group:
                    # fresh exception per waiter: raising the SAME object in
                    # B concurrent request threads mutates its shared
                    # __traceback__/__context__, garbling tracebacks across
                    # requests
                    err = RuntimeError(f"batched sampler call failed: {e!r}")
                    err.__cause__ = e
                    item.error = err
                    item.event.set()
