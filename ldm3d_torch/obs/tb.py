"""TensorBoard writing with the reference's scalar/image tags.

The port's own copy of ``MetricsWriter`` from ``ldm3d_tpu/obs/tb.py``: torch's
``SummaryWriter`` when ``tensorboard`` is installed, else a JSONL event log
(``metrics.jsonl``), so headless machines still get the metrics. Under data
parallelism only rank 0 writes (``enabled=False`` elsewhere).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["MetricsWriter"]


class MetricsWriter:
    def __init__(self, logdir: str, enabled: bool = True):
        self.logdir = logdir
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is not installed
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        else:
            self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value, step: int) -> None:
        v = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, v, step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": v,
                                          "step": step}) + "\n")
            self._jsonl.flush()

    def add_image(self, tag: str, img, step: int) -> None:
        """img: (1, H, W) float array in [0, 1] (or None, ignored)."""
        if img is None:
            return
        arr = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
        if self._tb is not None:
            self._tb.add_image(tag, arr, step, dataformats="CHW")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
