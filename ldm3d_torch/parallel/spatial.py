"""Spatial (depth) parallelism for volumetric models.

The port of ``ldm3d_tpu/parallel/spatial.py``. A volume's depth axis is split
over the ranks of a spatial group (:class:`SpatialGroup`, from the
``data x spatial`` layout of :func:`ldm3d_torch.parallel.mesh.set_layout`),
each rank holding one contiguous depth slab, and every operator stays exact:

* 3x3x3 convolutions exchange one-slab halos with their depth neighbours
  (:func:`halo_exchange`); the ranks at either end take zeros, which is the
  global SAME or (0, 1) zero padding;
* GroupNorm sums its fp32 moments over the group (one small all-reduce in
  the forward, one in the backward);
* attention keeps its queries local and gathers keys and values in depth
  order along the token axis (:func:`gather_tokens`), so the local queries
  meet every token of the volume.

Each collective is a ``torch.autograd.Function`` whose backward is its
adjoint: a halo's gradient goes back to the rank that owns its rows and is
added there, and the gathered tokens' gradient is summed over the group and
each rank keeps its own slice (a reduce-scatter). So a step on the slabs
computes the one-process step's gradients once the ranks' parameter
gradients are summed over the group.

:func:`spatial_clone` is JAX's ``module.clone(spatial_axis=...)``: the same
model over the same parameter tensors, its blocks bound to a group.
:func:`make_spatial_encoder` and :func:`make_spatial_sampler` are the
depth-sharded encode and sampler (JAX ``:103-197``); both take and return
this rank's slabs (:func:`shard_volume` cuts a global volume,
:meth:`SpatialGroup.all_gather` puts the slabs back together).

Transport. Under NCCL every collective runs on the device. gloo's
``all_reduce``, ``all_gather`` and ``reduce_scatter`` take CUDA tensors
(the GroupNorm sums, the token gather and its backward), but its
point-to-point ``isend``/``irecv`` reads host memory only (on a CUDA
tensor its TCP transport fails with "writev ... Bad address"), so under
gloo the halos of CUDA tensors travel through host tensors. The choice is
made by the group's backend, never by trying.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = [
    "SPATIAL_AXIS",
    "SpatialGroup",
    "halo_exchange",
    "gather_tokens",
    "shard_volume",
    "spatial_clone",
    "validate_spatial_divisibility",
    "make_spatial_encoder",
    "make_spatial_sampler",
]

SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class SpatialGroup:
    """The ranks that hold one volume's depth slabs: ``group`` their process
    group, ``ranks`` their global ranks in depth order, ``index`` this
    rank's place among them."""

    group: Any
    ranks: tuple
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @classmethod
    def current(cls) -> Optional["SpatialGroup"]:
        """The layout's spatial group (:func:`~ldm3d_torch.parallel.mesh.layout`),
        or None without a spatial axis."""
        from ldm3d_torch.parallel.mesh import layout

        lay = layout()
        if lay.spatial <= 1:
            return None
        return cls(lay.spatial_group, lay.spatial_ranks, lay.spatial_index)

    def exchange(self, sends: list, recvs: list) -> None:
        """Point-to-point: each ``(tensor, index)`` of ``sends`` goes to the
        group's rank ``index``; each ``(buffer, index)`` of ``recvs`` is
        filled from rank ``index``. All start together, then all are waited
        on (batched, so NCCL pairs them). Under gloo, whose point-to-point
        reads host memory only, CUDA tensors travel through host copies."""
        if not sends and not recvs:
            return
        staged = (sends or recvs)[0][0].is_cuda and dist.get_backend(self.group) == "gloo"
        ops, landed = [], []
        for t, i in sends:
            t = t.detach().contiguous()
            ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t, self.ranks[i],
                                  self.group))
        for buf, i in recvs:
            into = torch.empty(buf.shape, dtype=buf.dtype) if staged else buf
            landed.append((buf, into))
            ops.append(dist.P2POp(dist.irecv, into, self.ranks[i], self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for buf, into in landed:
            if into is not buf:
                buf.copy_(into)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced by its sum over the group, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` end to end along ``dim``, in depth order (the
        global volume from the slabs, with ``dim`` its depth)."""
        src = t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the group of ``g``, this rank's ``1 / size`` slice of
        it along ``dim``."""
        chunks = [c.contiguous() for c in g.chunk(self.size, dim=dim)]
        out = torch.empty_like(chunks[self.index])
        dist.reduce_scatter(out, chunks, group=self.group)
        return out


def _slab_shape(x: torch.Tensor, dim: int, rows: int) -> tuple:
    shape = list(x.shape)
    shape[dim] = rows
    return tuple(shape)


def _format_of(t: torch.Tensor) -> torch.memory_format:
    """channels_last_3d for an activation held in it (a one-channel one
    too), else contiguous."""
    if t.dim() == 5 and t.is_contiguous(memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return torch.contiguous_format


def _joined(parts: list, dim: int, like: torch.Tensor) -> torch.Tensor:
    """``parts`` end to end along ``dim`` in a new tensor with ``like``'s
    memory format's exact strides: a one-channel activation then gets
    channels_last strides, which ``torch.cat`` and ``contiguous`` leave
    ambiguous (either is contiguous), and the convolution after it keeps
    channels_last."""
    shape = list(parts[0].shape)
    shape[dim] = sum(p.shape[dim] for p in parts)
    out = torch.empty(shape, dtype=like.dtype, device=like.device,
                      memory_format=_format_of(like))
    offset = 0
    for p in parts:
        out.narrow(dim, offset, p.shape[dim]).copy_(p)
        offset += p.shape[dim]
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sg: SpatialGroup, lo: int, hi: int, dim: int):
        i, n, size = sg.index, sg.size, x.shape[dim]
        lo_buf = x.new_zeros(_slab_shape(x, dim, lo)) if lo else None
        hi_buf = x.new_zeros(_slab_shape(x, dim, hi)) if hi else None
        sends, recvs = [], []
        if lo:
            if i + 1 < n:
                sends.append((x.narrow(dim, size - lo, lo), i + 1))
            if i > 0:
                recvs.append((lo_buf, i - 1))
        if hi:
            if i > 0:
                sends.append((x.narrow(dim, 0, hi), i - 1))
            if i + 1 < n:
                recvs.append((hi_buf, i + 1))
        sg.exchange(sends, recvs)
        ctx.sg, ctx.lo, ctx.hi, ctx.dim, ctx.size = sg, lo, hi, dim, size
        parts = [p for p in (lo_buf, x, hi_buf) if p is not None]
        return _joined(parts, dim, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        sg, lo, hi, dim, size = ctx.sg, ctx.lo, ctx.hi, ctx.dim, ctx.size
        i, n = sg.index, sg.size
        gx = _joined([g.narrow(dim, lo, size)], dim, g)
        sends, recvs = [], []
        from_next = from_prev = None
        if lo:  # the lo halo held the previous rank's last rows
            if i > 0:
                sends.append((g.narrow(dim, 0, lo), i - 1))
            if i + 1 < n:
                from_next = g.new_empty(_slab_shape(g, dim, lo))
                recvs.append((from_next, i + 1))
        if hi:  # the hi halo held the next rank's first rows
            if i + 1 < n:
                sends.append((g.narrow(dim, lo + size, hi), i + 1))
            if i > 0:
                from_prev = g.new_empty(_slab_shape(g, dim, hi))
                recvs.append((from_prev, i - 1))
        sg.exchange(sends, recvs)
        if from_next is not None:
            gx.narrow(dim, size - lo, lo).add_(from_next)
        if from_prev is not None:
            gx.narrow(dim, 0, hi).add_(from_prev)
        return gx, None, None, None, None


def halo_exchange(x: torch.Tensor, sg: SpatialGroup, lo: int = 1, hi: int = 1,
                  dim: int = 2) -> torch.Tensor:
    """``x`` padded along ``dim`` (the depth of a logical NCDHW activation;
    1 for NDHWC) with ``lo`` rows from the previous rank's slab and ``hi``
    from the next one's; the ranks at either end take zeros
    (``ldm3d_tpu/parallel/spatial.py:48``). Differentiable: each halo's
    gradient is sent back to its owner and added there."""
    if not lo and not hi:
        return x
    return _HaloExchange.apply(x, sg, lo, hi, dim)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sg: SpatialGroup, dim: int):
        ctx.sg, ctx.dim = sg, dim
        return sg.all_gather(x, dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return ctx.sg.reduce_scatter(g, ctx.dim), None, None


def gather_tokens(x: torch.Tensor, sg: SpatialGroup, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` end to end along ``dim`` in depth order: the
    volume's keys or values ``(B, S * n, h, d)`` from each slab's
    ``(B, n, h, d)`` (JAX's tiled ``all_gather``). Its backward returns each
    rank the sum over the group of the gradient of its own slice."""
    return _GatherTokens.apply(x, sg, dim)


def shard_volume(x, sg: SpatialGroup, dim: int = 1):
    """This rank's depth slab of a global volume batch (NDHWC: ``dim`` 1;
    a tensor or an array; ``ValueError`` when the group does not divide the
    depth, with JAX's text)."""
    n = x.shape[dim]
    if n % sg.size:
        raise ValueError(f"depth {n} not divisible by spatial axis {sg.size}")
    per = n // sg.size
    index = [slice(None)] * x.ndim
    index[dim] = slice(sg.index * per, (sg.index + 1) * per)
    return x[tuple(index)]


def validate_spatial_divisibility(depth: int, n_spatial: int, num_downsamples: int) -> None:
    """Every downsample halves depth; each slab's local depth must stay even
    until the last level (``ldm3d_tpu/parallel/spatial.py:87``, its
    messages)."""
    local = depth // n_spatial
    if depth % n_spatial:
        raise ValueError(f"depth {depth} not divisible by spatial axis {n_spatial}")
    for i in range(num_downsamples):
        if local % 2:
            raise ValueError(
                f"local depth {local} odd before downsample {i}: "
                f"need depth divisible by {n_spatial * 2 ** num_downsamples}"
            )
        local //= 2


def spatial_clone(model: torch.nn.Module, sg: Optional[SpatialGroup]) -> torch.nn.Module:
    """``model`` over the same parameter tensors with every block that takes
    a spatial group (convolutions, GroupNorms, attention, upsamples) bound
    to ``sg``: JAX's ``clone(spatial_axis=...)``. The modules are shallow
    copies; the parameters, buffers and the model's settings at the time of
    the call (``compute_dtype``, ``remat``) are shared or copied from it."""

    def clone(m: torch.nn.Module) -> torch.nn.Module:
        c = copy.copy(m)
        c.__dict__["_modules"] = {k: None if v is None else clone(v)
                                  for k, v in m._modules.items()}
        if "spatial_group" in m.__dict__:
            c.__dict__["spatial_group"] = sg
        return c

    return clone(model)


def _sharded_draws(generator: torch.Generator, global_shape, sg: SpatialGroup, dp=None):
    """A standard normal of ``global_shape`` from ``generator``, then this
    rank's rows (``dp``) and depth slab (a copy: the whole draw is freed)."""
    x = torch.randn(tuple(global_shape), generator=generator, device=generator.device)
    if dp is not None:
        x = dp.shard(x)
    return shard_volume(x, sg).clone()


class _StepDraws:
    """A sampler's step noises, each drawn when the loop reads it (once a
    step, in step order), so no list of a whole schedule's draws is held."""

    def __init__(self, n: int, draw):
        self.n, self.draw = n, draw

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.draw()


def make_spatial_encoder(ae, sg: SpatialGroup):
    """Depth-sharded ``encode_stage_2_inputs`` (JAX ``:103``): returns
    ``encode(x, eps)`` from this rank's slab of the volumes ``x`` (NDHWC)
    and of the posterior's standard-normal ``eps`` to this rank's slab of
    the latents."""
    ae_sp = spatial_clone(ae, sg)

    @torch.no_grad()
    def encode(x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return ae_sp.encode_stage_2_inputs(x, eps)

    return encode


def make_spatial_sampler(unet, ae, scheduler, sg: SpatialGroup, scale_factor: float = 1.0,
                         guidance_scale: float = 1.0, dp=None):
    """Depth-sharded reverse loop and VAE decode (JAX ``:138``). Returns
    ``sampler(noise, condition=None, generator=None)``: ``noise`` and
    ``condition`` are this rank's latent slabs (NDHWC), the result this
    rank's slab of the decoded volumes. A sampler that adds noise each step
    (ddpm) draws each step's noise for the global batch and volume from
    ``generator`` and keeps this rank's rows (``dp``) and slab, so the
    slabs put together are the one-process sample of the same draws."""
    from ldm3d_torch.diffusion import inferer

    unet_sp, ae_sp = spatial_clone(unet, sg), spatial_clone(ae, sg)

    @torch.no_grad()
    def sampler(noise: torch.Tensor, condition: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        step_noises = None
        if getattr(scheduler, "draws_noise", False):
            rows = noise.shape[0] * (dp.world if dp is not None else 1)
            global_shape = (rows, noise.shape[1] * sg.size, *noise.shape[2:])
            step_noises = _StepDraws(len(scheduler.timesteps),
                                     lambda: _sharded_draws(generator, global_shape, sg, dp))
        latents = inferer.sample_latents(unet_sp, scheduler, noise, condition,
                                         guidance_scale=guidance_scale, generator=generator,
                                         step_noises=step_noises)
        latents = latents / torch.tensor(scale_factor, dtype=latents.dtype)
        return ae_sp.decode_stage_2_outputs(latents)

    return sampler
