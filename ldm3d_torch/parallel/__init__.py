"""Data and spatial parallelism over ``torch.distributed``: the port of
``ldm3d_tpu/parallel``'s data and spatial axes.

JAX holds one process with a device mesh; the port runs one process per
device, the ranks of the default process group being the data axis
(:mod:`.mesh`). ``-g N`` starts N ranks on one machine (:mod:`.launch`);
``torchrun`` (``--multihost``) starts them across machines (:mod:`.multihost`).
A step at N ranks computes what one process computes on the same global
batch: every draw is made for the global batch and sharded, and the
gradients are averaged over the ranks before the clip. ZeRO-1 (:mod:`.zero`)
shards Adam's moments; FSDP (:mod:`.fsdp`, ``fully_shard``) shards the
parameters, the moments and the EMA.

``--spatial S`` (:mod:`.spatial`) splits each volume's depth over S ranks
of a spatial group (the ranks ``data x spatial``, :func:`.mesh.set_layout`):
halo convolutions, GroupNorm sums over the group, gathered-kv attention; the
gradients are summed over the spatial group and averaged over the data axis.
Stage 2's train and eval steps and the sampler run it.

Not ported yet: ``tensor.py`` (``--tensor``), stage 1's and the server's
depth sharding, and ``pipeline.py`` (``--pipeline``), ROADMAP.md queue A,
'Parallelism' and 'UNet mid_depth stack, then pipeline parallelism'.
``compat.py`` is a shim over two versions of JAX's ``shard_map`` API and has
no counterpart here.

The submodules are imported on use: ``zero`` and ``fsdp`` build on
:mod:`ldm3d_torch.training`, which imports :mod:`.mesh`.
"""

from ldm3d_torch.parallel.mesh import (
    DataParallel,
    Layout,
    MeshSpec,
    data_index,
    data_size,
    dp_sample_placer,
    rank,
    set_layout,
    shard_batch,
    world,
)
from ldm3d_torch.parallel.multihost import global_batch, init_multihost, is_multihost

__all__ = ["DataParallel", "Layout", "MeshSpec", "data_index", "data_size", "dp_sample_placer",
           "rank", "set_layout", "shard_batch", "world", "global_batch", "init_multihost",
           "is_multihost"]
