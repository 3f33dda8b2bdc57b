"""The data and spatial axes over ``torch.distributed`` ranks.

The port of ``ldm3d_tpu/parallel/mesh.py``'s data and spatial axes. In JAX
one process holds a mesh whose ``data`` and ``spatial`` axes span the
devices, and a step's arrays are sharded over it; here each device is one
process (a rank), and the ranks of the default process group form the
``data x spatial`` layout:

* :class:`MeshSpec` resolves the axis sizes with the JAX package's rule and
  error text;
* :func:`set_layout` lays the ranks out: rank ``r`` sits at data index
  ``r // spatial`` and spatial index ``r % spatial`` (the spatial axis is
  the minor one, as ``create_mesh`` orders it), with one process group per
  spatial group and one per data group (:class:`Layout`); without it the
  layout is every rank on the data axis;
* :func:`world` and :func:`rank` read the process group (1 and 0 without
  one); :func:`data_size` and :func:`data_index` the data axis, which keys
  the batch rows, the loaders' shards and the global batch size;
* :class:`DataParallel` is what a train step needs of the axes: this rank's
  contiguous rows of a global batch (:meth:`DataParallel.shard`), the
  gradients summed over the spatial axis and averaged over the data axis
  (one all-reduce of a flat buffer), and sums and means over the data axis;
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

__all__ = ["MeshSpec", "Layout", "DataParallel", "world", "rank", "data_size", "data_index",
           "set_layout", "reset_layout", "layout", "shard_batch", "dp_sample_placer"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes ``(data, model, spatial, stage)``; ``data = -1`` takes every
    device the other axes leave (``ldm3d_tpu/parallel/mesh.py`` ``MeshSpec``).
    The port runs the data and spatial axes; ``model`` and ``stage`` must be
    1 until their slices land (ROADMAP.md queue A, 'Parallelism')."""

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


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the ``data x spatial`` layout and the process
    groups of its axes: ``spatial_group`` holds the ranks of this rank's
    volume slabs, in depth order (``spatial_ranks``), ``data_group`` the
    ranks that hold the same slab of the other replicas (None when the data
    axis is the whole default group)."""

    data: int
    spatial: int
    data_index: int
    spatial_index: int
    data_group: Any = None
    spatial_group: Any = None
    spatial_ranks: tuple = ()


# the layout set_layout made for the live process group, and the groups it
# built, by axis sizes (dist.new_group is a collective: every rank builds the
# same groups in the same order, once a process group)
_LAYOUT: list = []
_GROUPS: dict = {}


def set_layout(spec: MeshSpec) -> Layout:
    """Lay the default process group's ranks out as ``spec`` says and make it
    the layout that :func:`data_size`, :func:`data_index` and
    :meth:`DataParallel.current` read. Every rank must call it with the same
    ``spec`` (it builds process groups). Raises JAX's ``ValueError`` when the
    axes do not tile the ranks, and ``NotImplementedError`` for a ``model``
    or ``stage`` axis."""
    n = world()
    data, model, spatial, stage = spec.resolve(n)
    if model > 1 or stage > 1:
        raise NotImplementedError("the tensor and pipeline axes are not ported yet: ROADMAP.md "
                                  "queue A, 'Parallelism'")
    r = rank()
    groups = None
    if spatial > 1:
        key = (id(dist.group.WORLD), data, spatial)
        if key not in _GROUPS:
            sp = [dist.new_group([d * spatial + s for s in range(spatial)])
                  for d in range(data)]
            dg = [dist.new_group([d * spatial + s for d in range(data)])
                  for s in range(spatial)]
            _GROUPS[key] = (sp, dg)
        groups = _GROUPS[key]
    out = Layout(data=data, spatial=spatial, data_index=r // spatial,
                 spatial_index=r % spatial,
                 data_group=None if groups is None else groups[1][r % spatial],
                 spatial_group=None if groups is None else groups[0][r // spatial],
                 spatial_ranks=tuple((r // spatial) * spatial + s for s in range(spatial)))
    _LAYOUT[:] = [out]
    return out


def reset_layout() -> None:
    """Back to the default layout: every rank on the data axis."""
    _LAYOUT.clear()


def layout() -> Layout:
    """The layout :func:`set_layout` set, else every rank on the data axis."""
    if _LAYOUT:
        return _LAYOUT[0]
    return Layout(data=world(), spatial=1, data_index=rank(), spatial_index=0,
                  spatial_ranks=(rank(),))


def data_size() -> int:
    """Ranks on the data axis (the world without a spatial axis)."""
    return layout().data


def data_index() -> int:
    """This rank's index on the data axis (its rank without a spatial axis)."""
    return layout().data_index


def _rows(x, rank_: int, world_: int):
    n = x.shape[0]
    if n % world_:
        raise ValueError(f"global batch {n} not divisible by data axis {world_}")
    per = n // world_
    return x[rank_ * per:(rank_ + 1) * per]


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This rank's place on the data axis and the collectives a step takes.
    ``group`` is the data axis's process group (None: the default group)."""

    world: int
    rank: int
    group: Any = None

    @classmethod
    def current(cls) -> Optional["DataParallel"]:
        """The layout's data axis (:func:`layout`), or None with one rank."""
        if world() <= 1:
            return None
        lay = layout()
        return cls(lay.data, lay.data_index, lay.data_group)

    def shard(self, x):
        """This rank's contiguous ``batch / world`` rows of a global batch
        (a tensor or array); ``ValueError`` when the world does not divide it."""
        return None if x is None else _rows(x, self.rank, self.world)

    def global_rows(self, local: int) -> int:
        return local * self.world

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor by its sum over the spatial axis and mean over
        the data axis, in place: one all-reduce (sum) over every rank of one
        flat buffer per dtype and device, then a division by the data
        axis's size (without a spatial axis: the mean over the ranks)."""
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
        """The sum over the data axis of ``t`` (a new tensor)."""
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data axis of ``t`` (a new tensor; one all-reduce)."""
        return self.all_reduce_sum(t) / self.world

    def mean_of(self, value: float, device) -> float:
        """The mean over the data axis of a host number (one all-reduce)."""
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
