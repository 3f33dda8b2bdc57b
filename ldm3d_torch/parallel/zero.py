"""ZeRO-1: Adam's moments sharded over the data-parallel ranks.

The port of ``ldm3d_tpu/parallel/zero.py``. JAX places each moment tensor
with its largest dimension that the data axis divides (and that is at least
twice the axis) split over ``data``, leaves the others replicated, and lets
XLA all-gather the updated parameters. Here each rank keeps the moments of
its slice of every such tensor (:func:`zero_spec_for`, the JAX rule), runs
Adam on that slice alone, and the ranks then put the updated slices back
together with one all-gather of each rank's slices packed end to end (the
parameters are copies, so they stay bit-equal across ranks; gloo's
all-gather, like NCCL's, takes CUDA tensors). Small
tensors (biases, norms) keep replicated moments, as in JAX.

The clip still covers every parameter: the gradients are averaged whole on
every rank before it, so the global norm ``step()`` returns is the
one-process norm. The optimizer's ``state_dict`` gathers the moments into
the one-process layout, and ``load_state_dict`` takes this rank's slices of
one, so checkpoints move between world sizes and modes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ldm3d_torch.parallel.mesh import DataParallel
from ldm3d_torch.training.state import ClippedAdam, TrainState

__all__ = ["zero_spec_for", "ZeroClippedAdam", "shard_train_state_zero"]


def zero_spec_for(shape: Sequence[int], data_size: int) -> Optional[int]:
    """The dimension ZeRO splits over ``data_size`` ranks: the largest one
    that it divides and that is at least ``2 * data_size``
    (``ldm3d_tpu/parallel/zero.py:37`` ``zero_spec_for`` without a
    tensor-parallel base); None keeps the tensor replicated."""
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if d % data_size == 0 and d >= 2 * data_size and d > best_size:
            best, best_size = i, d
    return best


class ZeroClippedAdam(ClippedAdam):
    """A :class:`ClippedAdam` whose Adam state holds this rank's slices only.
    Built from a one-process optimizer (its state carried over) by
    :func:`shard_train_state_zero`."""

    def __init__(self, base: ClippedAdam, dp: DataParallel):
        self.__dict__.update(base.__dict__)
        self.dp = dp
        self.dims = [zero_spec_for(p.shape, dp.world) for p in self.params]
        self.locals = [p if d is None else self._slice(p.detach(), d).clone()
                       for p, d in zip(self.params, self.dims)]
        self.adam = base._adam_over(self.locals)
        self._load_adam_state(base.adam.state_dict())

    def _slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        per = t.shape[dim] // self.dp.world
        return t.narrow(dim, self.dp.rank * per, per)

    def _gather(self, pairs) -> None:
        """For each ``(full, local, dim)``: every rank's ``local`` slice
        written into ``full``, by one all-gather of this rank's slices packed
        end to end (every rank packs slices of the same sizes)."""
        if not pairs:
            return
        mine = torch.cat([local.reshape(-1) for _, local, _ in pairs])
        parts = [torch.empty_like(mine) for _ in range(self.dp.world)]
        dist.all_gather(parts, mine)
        for r, part in enumerate(parts):
            offset = 0
            for full, local, dim in pairs:
                per = full.shape[dim] // self.dp.world
                n = local.numel()
                full.narrow(dim, r * per, per).copy_(part[offset:offset + n].view(local.shape))
                offset += n

    @torch.no_grad()
    def _adam_step(self, count: int) -> None:
        sharded = []
        for p, loc, d in zip(self.params, self.locals, self.dims):
            if d is not None:
                loc.copy_(self._slice(p, d))
                loc.grad = self._slice(p.grad, d).contiguous()
                sharded.append((p, loc, d))
        super()._adam_step(count)
        by_dtype: dict = {}
        for p, loc, d in sharded:
            loc.grad = None
            by_dtype.setdefault((p.dtype, p.device), []).append((p.data, loc, d))
        for pairs in by_dtype.values():
            self._gather(pairs)

    def _adam_state_dict(self) -> dict:
        state = self.adam.state_dict()
        pairs_by_dtype: dict = {}
        for i, (p, d) in enumerate(zip(self.params, self.dims)):
            if d is None or i not in state["state"]:
                continue
            entry = state["state"][i]
            for key in ("exp_avg", "exp_avg_sq"):
                full = torch.empty(p.shape, dtype=entry[key].dtype, device=entry[key].device)
                pairs_by_dtype.setdefault(full.dtype, []).append((full, entry[key], d))
                entry[key] = full
        for pairs in pairs_by_dtype.values():
            self._gather(pairs)
        return state

    def _load_adam_state(self, state: dict) -> None:
        state = {"state": {i: dict(v) for i, v in state["state"].items()},
                 "param_groups": state["param_groups"]}
        for i, d in enumerate(self.dims):
            if d is None or i not in state["state"]:
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                state["state"][i][key] = self._slice(state["state"][i][key], d).clone()
        self.adam.load_state_dict(state)


def shard_train_state_zero(state: TrainState, dp: Optional[DataParallel]) -> TrainState:
    """ZeRO-1 the state's optimizer over ``dp``'s ranks, in place
    (``ldm3d_tpu/parallel/zero.py:72``); the parameters stay whole on every
    rank. A no-op with one rank, as JAX applies it only when ``data > 1``."""
    if dp is not None:
        state.optimizer = ZeroClippedAdam(state.optimizer, dp)
    return state
