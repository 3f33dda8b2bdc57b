"""Best / last / EMA checkpoints of one model, with resume.

The port of ``ldm3d_tpu/ckpt/manager.py`` with ``torch.save`` files in place
of orbax directories. Under ``model_dir``, role ``<role>`` of model
``<name>`` is the file ``<name>_<role>.pt``, a dict with a ``"meta"`` entry,
beside a ``<name>_<role>_meta.json`` sidecar. The inference CLI reads
``autoencoder_best.pt`` and ``diffusion_best.pt``: the ``best`` role, params
only, under ``"state_dict"``, with the latent ``scale_factor`` in its meta.
``last`` holds the whole train state (params, optimizer, step, EMA) for a
resume.

Saves are crash-atomic: each file is written to ``<file>.new`` and swapped
into place with ``os.replace``, so a kill at any instant leaves the previous
complete checkpoint or the new one, never a partial file; a leftover
``.new`` from a killed save is removed when the manager is constructed.

Under data parallelism rank 0 alone touches the files (the clean-up, every
write) and the other ranks wait at a barrier, as the JAX manager's lead
process does; callers gather the state on every rank first
(:meth:`ldm3d_torch.training.TrainState.state_dict` is the one-process
layout at any world size), so a checkpoint written at any world size, under
plain data parallelism, ZeRO-1 or FSDP, loads at any other. The JAX
package's orbax checkpoints are converted by ``tools/jax_to_torch_ckpt.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["CheckpointManager"]


def _ranks() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    """best / last / ema checkpoints of the model ``name`` under ``model_dir``."""

    def __init__(self, model_dir: str, name: str):
        self.root = os.path.abspath(model_dir)
        self.name = name
        self._lead = _ranks()[0] == 0
        if self._lead:
            os.makedirs(self.root, exist_ok=True)
            prefix = f"{name}_"
            for entry in os.listdir(self.root):
                if entry.startswith(prefix) and entry.endswith(".new"):
                    os.remove(os.path.join(self.root, entry))
        self._sync()

    def _sync(self) -> None:
        """Every rank waits here for rank 0's file work (no-op with one)."""
        if _ranks()[1] > 1:
            dist.barrier()

    def path(self, role: str) -> str:
        return os.path.join(self.root, f"{self.name}_{role}.pt")

    def _meta_path(self, role: str) -> str:
        return os.path.join(self.root, f"{self.name}_{role}_meta.json")

    def exists(self, role: str) -> bool:
        return os.path.isfile(self.path(role))

    def save(self, role: str, state: dict, meta: Optional[dict] = None) -> None:
        """Write ``state`` (a dict of tensors, numbers, nested dicts) and
        ``meta`` as role ``role``, atomically: rank 0 writes, every rank
        returns once the file is in place."""
        if self._lead:
            final = self.path(role)
            torch.save({**state, "meta": dict(meta or {})}, final + ".new")
            os.replace(final + ".new", final)
            tmp = self._meta_path(role) + ".new"
            with open(tmp, "w") as f:
                json.dump(dict(meta or {}), f)
            os.replace(tmp, self._meta_path(role))
        self._sync()

    def save_best_and_last(self, state: dict, is_best: bool, meta: Optional[dict] = None) -> None:
        """``last`` = the whole train state; ``best`` = its params only, under
        ``"state_dict"`` (the deployment artifact other stages load)."""
        if "params" not in state:
            raise TypeError("save_best_and_last expects a train state with a 'params' key")
        self.save("last", state, meta)
        if is_best:
            self.save("best", {"state_dict": state["params"]}, meta)

    def load(self, role: str, map_location: Any = None) -> dict:
        if not self.exists(role):
            raise FileNotFoundError(f"no {self.name} checkpoint {role!r} at {self.path(role)}")
        return torch.load(self.path(role), map_location=map_location, weights_only=True)

    def load_meta(self, role: str) -> dict:
        if not os.path.exists(self._meta_path(role)):
            return {}
        with open(self._meta_path(role)) as f:
            return json.load(f)

    def try_restore(self, role: str, map_location: Any = None) -> tuple[Optional[dict], bool]:
        """``(state, True)`` if the role exists, else ``(None, False)``: callers
        log which, a resume that finds nothing starts from scratch."""
        if not self.exists(role):
            return None, False
        return self.load(role, map_location), True
