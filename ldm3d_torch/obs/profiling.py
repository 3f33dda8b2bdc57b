"""Profiling hooks: the port of ``ldm3d_tpu/obs/profiling.py``.

``--profile`` (stage 1, as in JAX) opens a ``torch.profiler`` window over
the CPU and, when there is one, the CUDA device: steps [wait, wait + active)
are traced and written as a Chrome trace under ``logdir``. Steps outside the
window cost nothing.
"""

from __future__ import annotations

import logging
import os
import time

import torch

__all__ = ["StepProfiler", "Stopwatch"]

log = logging.getLogger("profiling")


class StepProfiler:
    """Trace steps [wait, wait + active) to ``logdir`` when enabled.

    ``wait`` skips the first steps (warm-up, kernel builds); the trace covers
    the next ``active`` steps. If the run ends before the window opens (fewer
    than ``wait + 1`` steps), :meth:`stop` says so instead of silently
    writing nothing. :attr:`trace_path` is the file written, once written."""

    def __init__(self, logdir: str, enabled: bool = False, wait: int = 1, active: int = 3):
        self.logdir = logdir
        self.enabled = enabled
        self.wait = wait
        self.active = active
        self.trace_path = None
        self._step = 0
        self._prof = None
        self._traced = False

    def step(self) -> None:
        """Call after each step."""
        if not self.enabled:
            return
        if self._step == self.wait and self._prof is None:
            self._start()
        if self._step == self.wait + self.active and self._prof is not None:
            self._write()
        self._step += 1

    def stop(self) -> None:
        """Call once at the end of the run: writes an open window, or warns
        that none opened."""
        if self._prof is not None:
            self._write()
        elif self.enabled and not self._traced:
            log.warning(
                "--profile produced no trace: only %d step(s) ran, the window "
                "opens at step %d — run more steps or lower `wait`",
                self._step, self.wait + 1)

    def _start(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self._traced = True

    def _write(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        self.trace_path = os.path.join(self.logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(self.trace_path)
        log.info("profiler trace written to %s", self.trace_path)


class Stopwatch:
    """Wall time between laps. On the card, callers synchronise the device
    (``torch.cuda.synchronize``) before ``lap``: kernels run asynchronously."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt
