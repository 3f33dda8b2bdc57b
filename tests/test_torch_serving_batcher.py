"""The port's dynamic micro-batcher (``ldm3d_torch/serving/batcher.py``):
merging, padding, error fan-out and close, as ``tests/test_batcher.py``
holds the JAX package's."""

import threading
import time

import numpy as np
import pytest

from ldm3d_torch.serving.batcher import DynamicBatcher


def test_concurrent_submissions_merge_and_results_route():
    calls = []

    def run_batch(noise, rng_seed, cond):
        calls.append(noise.shape[0])
        time.sleep(0.02)  # give submitters time to queue up behind call 1
        return noise * 2.0

    b = DynamicBatcher(run_batch, batch_size=4, max_wait_ms=2000)
    try:
        results = {}

        def client(i):
            results[i] = b.submit(np.full((2, 2), float(i)), rng_seed=0, timeout=10)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        for i in range(8):
            np.testing.assert_array_equal(results[i], np.full((2, 2), 2.0 * i))
        # 8 samples arrived concurrently: fewer batched calls than samples
        assert b.samples_run == 8
        # the 2s window makes merging robust to slow/loaded runners (each
        # window still closes EARLY once 4 items arrive, so the test stays
        # fast); 8 samples over batch-4 calls = 2 in the common case
        assert b.batches_run <= 4, f"no merging happened: {calls}"
        assert all(c == 4 for c in calls)  # every call padded/filled to B
    finally:
        b.close()


def test_partial_batch_pads_and_trims():
    def run_batch(noise, rng_seed, cond):
        assert noise.shape[0] == 4  # always the compiled batch size
        assert cond.shape[0] == 4
        return noise + cond

    b = DynamicBatcher(run_batch, batch_size=4, max_wait_ms=1)
    try:
        out = b.submit(np.ones((3,)), cond=np.full((3,), 10.0), timeout=10)
        np.testing.assert_array_equal(out, np.full((3,), 11.0))
        assert b.batches_run == 1
    finally:
        b.close()


def test_error_propagates_to_every_waiter():
    def run_batch(noise, rng_seed, cond):
        raise RuntimeError("boom")

    b = DynamicBatcher(run_batch, batch_size=2, max_wait_ms=1)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.submit(np.zeros((1,)), timeout=10)
    finally:
        b.close()


def test_closed_batcher_rejects():
    b = DynamicBatcher(lambda n, s, c: n, batch_size=2, max_wait_ms=1)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((1,)))

