"""The data-parallel axis over ``torch.distributed`` ranks.

The port of ``ldm3d_tpu/parallel/mesh.py``'s data axis. In JAX one process
holds a mesh whose ``data`` axis spans the devices, and a step's arrays are
sharded over it; here each device is one process (a rank), and the ranks of
the default process group are the data axis:

* :class:`MeshSpec` resolves the axis sizes with the JAX package's rule and
  error text;
* :func:`world` and :func:`rank` read the process group (1 and 0 without one);
* :class:`DataParallel` is what a train step needs of the axis: this rank's
  contiguous rows of a global batch (:meth:`DataParallel.shard`), the mean of
  the gradients over the ranks (one all-reduce of a flat buffer), and sums
  over the ranks;
* :func:`shard_batch` and :func:`dp_sample_placer` are the JAX functions of
  those names for this layout.

Every random draw of a step is made for the *global* batch from a generator
seeded alike on every rank, then sharded, so a step at N ranks computes what
one process computes on the same global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["MeshSpec", "DataParallel", "world", "rank", "shard_batch", "dp_sample_placer"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes ``(data, model, spatial, stage)``; ``data = -1`` takes every
    device the other axes leave (``ldm3d_tpu/parallel/mesh.py`` ``MeshSpec``).
    The port runs the data axis only; the others must be 1 until their
    slices land (ROADMAP.md queue A, 'Parallelism')."""

    data: int = -1
    model: int = 1
    spatial: int = 1
    stage: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        model = max(1, self.model)
        spatial = max(1, self.spatial)
        stage = max(1, self.stage)
        data = self.data if self.data > 0 else n_devices // (model * spatial * stage)
        if data * model * spatial * stage != n_devices:
            raise ValueError(
                f"mesh {data}x{model}x{spatial}x{stage} does not tile {n_devices} devices")
        return data, model, spatial, stage


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if _initialized() else 0


def _rows(x, rank_: int, world_: int):
    n = x.shape[0]
    if n % world_:
        raise ValueError(f"global batch {n} not divisible by data axis {world_}")
    per = n // world_
    return x[rank_ * per:(rank_ + 1) * per]


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This rank's place on the data axis and the collectives a step takes."""

    world: int
    rank: int

    @classmethod
    def current(cls) -> Optional["DataParallel"]:
        """The default process group's axis, or None with one rank."""
        return cls(world(), rank()) if world() > 1 else None

    def shard(self, x):
        """This rank's contiguous ``batch / world`` rows of a global batch
        (a tensor or array); ``ValueError`` when the world does not divide it."""
        return None if x is None else _rows(x, self.rank, self.world)

    def global_rows(self, local: int) -> int:
        return local * self.world

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the ranks, in place: one
        all-reduce (sum) of one flat buffer per dtype and device, then a
        division by the world."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault((t.dtype, t.device), []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat)
            flat.div_(self.world)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t`` (a new tensor)."""
        out = t.clone()
        dist.all_reduce(out)
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``t`` (a new tensor; one all-reduce)."""
        return self.all_reduce_sum(t) / self.world

    def mean_of(self, value: float, device) -> float:
        """The mean over the ranks of a host number (one all-reduce)."""
        return float(self.mean(torch.tensor([float(value)], dtype=torch.float64,
                                            device=device)).item())


def shard_batch(batch: Any, dp: Optional[DataParallel] = None):
    """This rank's contiguous slice of a global batch (a tensor, an array or a
    dict of them): ``ldm3d_tpu/parallel/mesh.py`` ``shard_batch`` for one
    process a device. With one rank the batch is returned as it is."""
    dp = dp if dp is not None else DataParallel.current()
    if dp is None:
        return batch
    if isinstance(batch, dict):
        return {k: dp.shard(v) for k, v in batch.items()}
    return dp.shard(batch)


def dp_sample_placer(batch: int, dp: Optional[DataParallel] = None):
    """``(place, n_shards)`` for data-parallel sampling
    (``ldm3d_tpu/parallel/mesh.py:69``): ``place`` takes this rank's rows of a
    global sampling batch, so each rank denoises and decodes ``batch / n``
    volumes. It is the identity with ``n_shards = 1`` with one rank or when
    the world does not divide ``batch``; every rank then samples the whole
    batch, as JAX then samples on one chip."""
    dp = dp if dp is not None else DataParallel.current()
    if dp is None or batch % dp.world:
        return (lambda x: x), 1
    return dp.shard, dp.world
