"""Graceful shutdown on SIGTERM: the port of ``ldm3d_tpu/training/preemption.py``.

A scheduler that reclaims a machine sends SIGTERM ahead of the kill. The
trainers poll :class:`GracefulShutdown` once a batch; on a pending signal
they save a resumable ``last`` checkpoint (meta ``epoch`` = the interrupted
epoch - 1, ``preempted: True``) and exit 75 (``EX_TEMPFAIL``), so a restart
with ``resume_ckpt`` replays the interrupted epoch.

Under data parallelism :attr:`GracefulShutdown.requested_global` is the
flag every rank agrees on: a ``MAX`` all-reduce of the local flags, taken by
every rank at every step boundary (``ldm3d_tpu/training/preemption.py:67``),
so one rank's SIGTERM stops all of them at the same step and the next
collective (the checkpoint's gather) finds every rank.
"""

from __future__ import annotations

import logging
import signal
import threading

import torch

__all__ = ["GracefulShutdown"]

log = logging.getLogger("preemption")


class GracefulShutdown:
    """Latches SIGTERM (and optionally other signals) into a pollable flag.

    As a context manager it re-installs the previous handlers on every way
    out of its block (return, ``SystemExit`` or any other exception), so no
    handler of a finished run is left behind in the process."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:  # not the main thread (tests, embedded use)
                log.warning("cannot install handler for %s off the main thread", sig)

    def _handle(self, signum, frame):
        log.warning("received %s: finishing current step, then saving 'last' "
                    "checkpoint and exiting", signal.Signals(signum).name)
        self._flag.set()

    @property
    def requested(self) -> bool:
        """The local process's flag."""
        return self._flag.is_set()

    @property
    def requested_global(self) -> bool:
        """The flag as every rank agrees on it: True on every rank once any
        rank latched the signal. Every rank must read it at the same points
        (a collective); with one process it is the local flag."""
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
            return self.requested
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor([int(self.requested)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def trigger(self) -> None:
        """Set the flag programmatically (tests, cooperative shutdown)."""
        self._flag.set()

    def restore(self) -> None:
        """Re-install the previous signal handlers."""
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def __enter__(self) -> "GracefulShutdown":
        return self

    def __exit__(self, *exc) -> None:
        self.restore()
