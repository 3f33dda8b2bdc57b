"""Process-group start-up from ``torchrun``'s environment, and global arrays.

The port of ``ldm3d_tpu/parallel/multihost.py``. JAX runs one process per
host and ``jax.distributed.initialize()`` finds the coordinator; the port
runs one process per GPU, as ``torchrun`` starts them, and each reads the
rendezvous from the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). ``--multihost`` takes
this path, as in JAX only when asked (the CLIs refuse torchrun's environment
without it); ``-g N`` on one machine starts its N ranks itself
(:mod:`ldm3d_torch.parallel.launch`).

:func:`global_batch` is JAX's assembly of per-process batches into one global
array, here an ``all_gather`` along the batch axis, for the places that need
every rank's rows in one process (the sampler's writer, rank 0).
"""

from __future__ import annotations

import atexit
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("multihost")

__all__ = ["init_multihost", "is_multihost", "global_batch", "torchrun_env"]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def torchrun_env() -> bool:
    """Whether ``torchrun``'s rendezvous variables are all set."""
    return all(os.environ.get(k) for k in _ENV)


def init_multihost(device_type: str = "cuda") -> tuple[int, int]:
    """Initialise the default process group from ``torchrun``'s environment;
    returns ``(rank, world)``. NCCL on the card (each rank takes the GPU
    ``LOCAL_RANK``), gloo on the CPU; the group is destroyed when the process
    exits. Calling it again is a no-op with a warning; a missing variable or
    a failed rendezvous raises."""
    if dist.is_initialized():
        log.warning("torch.distributed is already initialised")
        return dist.get_rank(), dist.get_world_size()
    missing = [k for k in _ENV if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"--multihost needs torchrun's environment; {', '.join(missing)} "
                           "unset (launch with torchrun --nproc-per-node N ..., or use -g N "
                           "on one machine)")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://")
    # the group's threads must not outlive the interpreter (a process that
    # exits with them running aborts, and torchrun then fails the run)
    atexit.register(_destroy)
    r, n = dist.get_rank(), dist.get_world_size()
    log.info("multihost: rank %d of %d (%s)", r, n, dist.get_backend())
    return r, n


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_batch(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``local`` rows end to end, in rank order (an
    ``all_gather`` over ``group``, the default group when None; all its
    ranks call it with equal shapes), on ``local``'s device: gloo's and
    NCCL's all-gathers both take CUDA tensors."""
    if not is_multihost():
        return local
    x = local.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)
