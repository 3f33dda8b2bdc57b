"""FSDP (ZeRO-3): parameters, Adam's moments and the EMA sharded over the ranks.

The port of ``ldm3d_tpu/parallel/fsdp.py`` with PyTorch's own
``torch.distributed.fsdp.fully_shard`` (FSDP2), one unit per ResBlock and
attention block and the root for the rest: the model's parameters become
``DTensor`` shards, all-gathered block by block for its forward and its
backward, and their gradients reduce-scattered (averaged) over the ranks. The optimizer is
rebuilt over the sharded parameters, so Adam's moments and the EMA copy are
sharded alike. Each parameter is split along the dimension ZeRO-1 picks
(:func:`ldm3d_torch.parallel.zero.zero_spec_for`, JAX's rule), else along
dimension 0.

The clip covers every parameter: the norm is the square root of the
all-reduced sum of each rank's local sums of squares, so the norm ``step()``
returns is the one-process norm. :meth:`TrainState.state_dict` gathers the
whole tensors (the one-process layout); a resume loads its checkpoint before
:func:`shard_train_state_fsdp`, as the JAX trainers restore before sharding.

Under FSDP a loss must reach the parameters through ``backward()``:
``torch.autograd.grad`` leaves FSDP no ``.grad`` to reduce-scatter.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ldm3d_torch.nn.blocks import AttentionBlock3D, ResBlock3D, TimeResBlock3D
from ldm3d_torch.parallel.mesh import DataParallel
from ldm3d_torch.parallel.zero import zero_spec_for
from ldm3d_torch.training.state import ClippedAdam, TrainState, clip_by_global_norm_

__all__ = ["FSDPClippedAdam", "shard_model_fsdp", "shard_train_state_fsdp"]

# the units fully_shard wraps one by one, below the root
_BLOCKS = (ResBlock3D, TimeResBlock3D, AttentionBlock3D)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _to_dtensor_like(value: torch.Tensor, like) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(like.device), like.device_mesh, like.placements)


class FSDPClippedAdam(ClippedAdam):
    """A :class:`ClippedAdam` over ``fully_shard``'s parameters: FSDP has
    averaged the gradients already, the norm sums each rank's shards, and
    the clip and Adam act on the local shards."""

    def __init__(self, base: ClippedAdam, params, dp: DataParallel):
        self.__dict__.update(base.__dict__)
        self.dp = dp
        self.params = [p for p in params if p.requires_grad]
        if self.acc_grads is not None:  # a resumed accumulation carries over, sharded
            self.acc_grads = [_to_dtensor_like(a, p) for a, p in zip(base.acc_grads, self.params)]
        self.adam = base._adam_over(self.params)
        self._load_adam_state(base.adam.state_dict())

    def _reduce_grads(self, grads) -> None:
        pass  # fully_shard reduce-scattered (averaged) them in the backward

    def _global_norm(self, tensors) -> torch.Tensor:
        local = sum(torch.sum(_local(t).float() * _local(t).float()) for t in tensors)
        local = torch.as_tensor(local, dtype=torch.float32, device=_local(tensors[0]).device)
        dist.all_reduce(local)
        return torch.sqrt(local)

    def _clip(self, tensors) -> torch.Tensor:
        return clip_by_global_norm_([_local(t) for t in tensors], self.grad_clip,
                                    self._global_norm(tensors))

    def _adam_state_dict(self) -> dict:
        state = self.adam.state_dict()
        for entry in state["state"].values():
            for key in ("exp_avg", "exp_avg_sq"):
                if hasattr(entry.get(key), "full_tensor"):
                    entry[key] = entry[key].full_tensor()
        return state

    def _load_adam_state(self, state: dict) -> None:
        state = {"state": {i: dict(v) for i, v in state["state"].items()},
                 "param_groups": state["param_groups"]}
        for i, entry in state["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in entry and not hasattr(entry[key], "device_mesh"):
                    entry[key] = _to_dtensor_like(entry[key], self.params[i])
        self.adam.load_state_dict(state)


def shard_model_fsdp(model: torch.nn.Module, dp: DataParallel) -> torch.nn.Module:
    """``fully_shard`` the model over the default process group, each
    parameter split along :func:`zero_spec_for`'s dimension (else 0). Each
    ResBlock and attention block is a unit of its own, then the root takes
    the rest: a block's parameters are whole only while it runs (and while
    its backward runs), not for the whole step."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    device = next(model.parameters()).device
    mesh = init_device_mesh(device.type, (dp.world,))

    def placement(p: torch.nn.Parameter):
        d = zero_spec_for(p.shape, dp.world)
        return Shard(0 if d is None else d)

    for module in model.modules():
        if module is not model and isinstance(module, _BLOCKS):
            fully_shard(module, mesh=mesh, shard_placement_fn=placement)
    return fully_shard(model, mesh=mesh, shard_placement_fn=placement)


def shard_train_state_fsdp(state: TrainState, dp: Optional[DataParallel]) -> TrainState:
    """FSDP the state in place (``ldm3d_tpu/parallel/fsdp.py:45``): the model
    sharded, the optimizer rebuilt over its shards with its moments carried
    over, the EMA sharded alike. A no-op with one rank, as in JAX."""
    if dp is None:
        return state
    shard_model_fsdp(state.model, dp)
    named = dict(state.model.named_parameters())
    state.optimizer = FSDPClippedAdam(state.optimizer, list(named.values()), dp)
    if state.ema_params is not None:
        state.ema_params = {n: _to_dtensor_like(e, named[n]) for n, e in state.ema_params.items()}
    return state
