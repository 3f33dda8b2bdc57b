"""Start N ranks on this machine and run functions on all of them.

``-g N`` with N > 1 and no ``torchrun`` environment starts its ranks here:
one spawned process a rank, each with the default process group initialised
(NCCL on the card with one GPU a rank, gloo on the CPU), each running the
CLI's ``main`` with the same argv. The parent is not a rank: it waits for
the ranks, kills them all when one fails or the time limit passes, and
returns rank 0's result or raises the first rank's error (``SystemExit``
codes pass through, so a preempted run still exits 75).

:class:`RankPool` keeps the ranks and their process group alive across
calls (the tests hold one pool a file; ``chip_smoke.py`` runs its checks in
one). ``devices`` assigns each rank its device: ``["cuda:0", "cuda:1"]``
normally, ``["cuda:0", "cuda:0"]`` to time-share one card over gloo (NCCL
refuses two ranks on one GPU), ``["cpu", "cpu"]`` for the CPU.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

__all__ = ["RankPool", "launch", "free_port", "group_of_one", "RankError"]

# once one rank has failed, how long the others get to answer before every
# rank is killed (a rank waiting in a collective the failed one never joins
# would otherwise wait for the collective's own timeout)
GRACE_S = 5.0


class RankError(RuntimeError):
    """A rank raised an exception that could not be carried to the parent."""


def free_port() -> int:
    """A free TCP port on localhost (bind port 0, read it, release it)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def group_of_one(backend: str):
    """The default process group over this process alone (world 1) inside
    the block: what FSDP and the collectives need to run in one process."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _worker(rank: int, world: int, port: int, backend: str, device: str,
            timeout_s: Optional[float], threads: Optional[int], conn) -> None:
    import torch.distributed as dist

    from ldm3d_torch.parallel.mesh import reset_layout

    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s or 1800.0))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        conn.send(("error", _portable(e)))
        return
    conn.send(("ok", None))  # ready
    try:
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, args, kwargs = task
            reset_layout()  # each task starts with every rank on the data axis
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except SystemExit as e:
                conn.send(("exit", e.code))
            except BaseException as e:  # noqa: BLE001 - reported to the parent
                conn.send(("error", _portable(e)))
    finally:
        dist.destroy_process_group()
        conn.close()


def _portable(e: BaseException) -> BaseException:
    """The exception itself when it pickles, else a RankError with its
    text; the rank's traceback rides along as ``rank_traceback``."""
    import pickle

    tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
    try:
        pickle.loads(pickle.dumps(e))
        e.rank_traceback = tb
        return e
    except Exception:  # noqa: BLE001
        return RankError(tb)


class RankPool:
    """``world`` ranks with a live process group; :meth:`run` calls
    ``fn(*args, **kwargs)`` on every rank and returns the results in rank
    order. ``fn`` must be importable by name (a module-level function).

    ``timeout_s`` bounds each :meth:`run` (None: no bound, the collectives'
    own 30 min timeout; start-up has at least 180 s); once a rank has failed
    the others get GRACE_S to answer; on expiry, or when a rank dies, every
    rank is killed and the call raises. A rank's exception
    is raised in the parent (the lowest rank's); if every rank exited with
    ``SystemExit``, the parent raises the same ``SystemExit``."""

    def __init__(self, world: int, devices: Optional[Sequence[str]] = None,
                 backend: Optional[str] = None, timeout_s: Optional[float] = 600.0,
                 threads: Optional[int] = None):
        import multiprocessing as mp

        devices = list(devices or ["cpu"] * world)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        backend = backend or ("nccl" if torch.device(devices[0]).type == "cuda" else "gloo")
        self.world, self.devices, self.backend, self.timeout_s = world, devices, backend, timeout_s
        ctx = mp.get_context("spawn")
        port = free_port()
        self._conns, self._procs = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(r, world, port, backend, devices[r], timeout_s,
                                                  threads, child), daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._collect("start-up", limit_s=max(self.timeout_s or 0.0, 180.0))

    def _collect(self, what: str, limit_s: Optional[float] = None) -> list:
        """Every rank's reply within ``limit_s`` (default ``timeout_s``). Once
        one rank has failed (an exception, an exit or its death), the others
        get GRACE_S to answer (they may wait in a collective the failed
        rank never joins); then every rank is killed and the failure raised."""
        limit_s = limit_s or self.timeout_s
        deadline = time.monotonic() + (limit_s or float("inf"))
        replies: list = [None] * self.world
        while None in replies and time.monotonic() < deadline:
            for r, (conn, proc) in enumerate(zip(self._conns, self._procs)):
                if replies[r] is not None:
                    continue
                try:
                    got = conn.recv() if conn.poll(0.05) else None
                except (EOFError, OSError):
                    got = None
                if got is None and not proc.is_alive():
                    got = ("error", RankError(f"rank {r} died during {what} "
                                              f"(exit code {proc.exitcode})"))
                if got is not None:
                    replies[r] = got
                    if got[0] != "ok":
                        deadline = min(deadline, time.monotonic() + GRACE_S)
        failed = [(r, rep) for r, rep in enumerate(replies) if rep is not None and rep[0] != "ok"]
        if None in replies or 0 < len(failed) < self.world:  # some rank may be stuck
            self.kill()
        if not failed and None in replies:
            raise TimeoutError(f"ranks {[r for r, rep in enumerate(replies) if rep is None]} "
                               f"gave no answer within {limit_s} s during {what}; every rank "
                               "was killed")
        errors = [(r, v) for r, (kind, v) in failed if kind == "error"]
        if errors:
            r, e = errors[0]
            if hasattr(e, "rank_traceback"):
                print(f"rank {r} raised:\n{e.rank_traceback}", flush=True)
            raise e
        if failed:
            codes = {v for _, (_, v) in failed}
            if len(failed) != self.world or len(codes) != 1:
                raise RankError(f"ranks {[r for r, _ in failed]} exited with "
                                f"{sorted(codes, key=str)} and the others did not")
            raise SystemExit(codes.pop())
        return [v for _, v in replies]

    def run(self, fn: Callable, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results in rank order."""
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "run"))

    def close(self) -> None:
        for conn, p in zip(self._conns, self._procs):
            try:
                if p.is_alive():
                    conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=30)
        self.kill()

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        for conn in self._conns:
            conn.close()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn: Callable, world: int, *args, devices: Optional[Sequence[str]] = None,
           backend: Optional[str] = None, timeout_s: Optional[float] = 3600.0,
           threads: Optional[int] = None, **kwargs) -> list:
    """Start ``world`` ranks, run ``fn(*args, **kwargs)`` once on each, stop
    them; the results in rank order (see :class:`RankPool`)."""
    with RankPool(world, devices, backend, timeout_s, threads) as pool:
        return pool.run(fn, *args, **kwargs)


def run_cli(main: Callable, argv: list, want_timings: bool) -> tuple[Any, Optional[dict]]:
    """A rank's share of a CLI launched with ``-g N``: ``main(argv)`` with
    the default process group already up; returns its result and, when
    asked, its ``timings`` record."""
    timings: Optional[dict] = {} if want_timings else None
    out = main(argv, timings=timings) if want_timings else main(argv)
    return out, timings
