"""GroupNorm voxel reductions: per-(batch, channel) fp32 sums.

Counterpart of ``ldm3d_tpu/ops/groupnorm.py``. Every GroupNorm of the port
calls :func:`gn_sums` for its statistics and :func:`gn_bwd_sums` in its
backward (``ldm3d_torch/nn/blocks.py``, as ``_gn_stats`` and ``_gn_affine_bwd``
of ``ldm3d_tpu/nn/blocks.py`` do).

Layout. The JAX functions take ``x`` as ``(B, V, C)``. Here ``x`` is the
port's activation, ``(B, C, *spatial)`` logical in ``channels_last_3d``
memory, which the kernels read as ``(B, V, C)`` through its strides. On the
card, ``x`` must have unit channel stride, and ``dy`` may have any layout
whose spatial dims flatten to one stride; anything else raises, and the
wrapper never makes a hidden ``.contiguous()`` copy.

On CUDA tensors the sums run the hand-written kernels of
``csrc/groupnorm_sums.cu`` (which replace the TPU's ``_sums_kernel`` and
``_bwd_sums_kernel``, ``ldm3d_tpu/ops/groupnorm.py:70`` and ``:144``); on CPU
tensors the plain PyTorch versions :func:`gn_sums_reference` and
:func:`gn_bwd_sums_reference`. Any other device raises. Each is one kernel
launch a call: each block sums a chunk of voxels, and the chunks' partials of
a (batch, channel group) are added in a fixed order, in a thread-block
cluster or by the last block to finish (:func:`gn_sums_plan` and
:func:`gn_bwd_sums_plan` lay out the grids). Each wrapper counts its calls of
the C entry point in ``<wrapper>.launches``, and by input in
``<wrapper>.cases``: a dict from ``(shape, dtype, strides of x[, strides of
dy])`` to launches, from which a caller can rebuild the exact inputs a run
gave the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

__all__ = ["GnPlan", "gn_sums", "gn_sums_plan", "gn_bwd_sums", "gn_bwd_sums_plan",
           "gn_sums_reference", "gn_bwd_sums_reference", "workspace_buffers"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# blocks a gn_sums call aims for at large inputs (about 8 per SM of an H100)
_TARGET_BLOCKS = 1024
# threads of a block (csrc/groupnorm_sums.cu GN_NT), and the fewest loads
# each thread of a gn_sums block makes (more blocks for a small volume would
# only add partials)
_GN_THREADS = 256
_GN_MIN_LOADS = 8
# the most blocks a portable thread-block cluster holds
_GN_MAX_CLUSTER = 8
# gn_bwd_sums (tuned on the H100 with ldm3d_torch.tools.gn_sweep, PERF.md):
# the blocks a call aims for (about 3 an SM), the fewest loads of each
# operand a thread makes (4 in a volume of at most _BWD_FEW_ROWS voxel rows a
# thread), and the most voxel rows a thread at which the chunks of a channel
# group form a cluster
_BWD_TARGET_BLOCKS = 384
_BWD_MIN_LOADS = 8
_BWD_FEW_ROWS = 256
_BWD_FEW_MIN_LOADS = 4
_BWD_CLUSTER_ROWS = 64


def _spatial_dims(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(2, x.dim()))


def gn_sums_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``(sum_v x, sum_v x^2)``, fp32 ``(B, C)`` each."""
    xf = x.float()
    dims = _spatial_dims(x)
    return xf.sum(dim=dims), (xf * xf).sum(dim=dims)


def gn_bwd_sums_reference(dy: torch.Tensor, x: torch.Tensor, mean_c: torch.Tensor,
                          inv_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``(sum_v dy, sum_v dy * x_hat)`` with
    ``x_hat = (x - mean_c) * inv_c``, fp32 ``(B, C)`` each."""
    shape = mean_c.shape + (1,) * (x.dim() - 2)
    dyf = dy.float()
    xhat = (x.float() - mean_c.reshape(shape)) * inv_c.reshape(shape)
    dims = _spatial_dims(x)
    return dyf.sum(dim=dims), (dyf * xhat).sum(dim=dims)


def _bvc_strides(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    """``(batch, voxel, channel)`` element strides of a ``(B, C, *spatial)``
    tensor whose spatial dims flatten to one stride; raises otherwise."""
    sv, expected = None, None
    for size, stride in reversed(list(zip(t.shape[2:], t.stride()[2:]))):
        if size == 1:
            continue
        if sv is None:
            sv = stride
        elif stride != expected:
            raise ValueError(f"GroupNorm sums kernel: the spatial dims of {name} "
                             f"{tuple(t.shape)} with strides {t.stride()} do not flatten to "
                             f"one voxel stride (take channels_last_3d or NCDHW memory)")
        expected = stride * size
    return t.stride(0), (1 if sv is None else sv), t.stride(1)


def _check(x: torch.Tensor) -> tuple[int, int, int]:
    if x.dim() < 3:
        raise ValueError(f"GroupNorm sums take (batch, channels, *spatial), got {tuple(x.shape)}")
    b, c = x.shape[:2]
    v = math.prod(x.shape[2:])
    if min(b, c, v) == 0:
        raise ValueError(f"empty GroupNorm input {tuple(x.shape)}")
    return b, v, c


def _x_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """``x``'s ``(batch, voxel, channel)`` element strides; raises unless its
    channels are minor in memory (``channels_last_3d``)."""
    sb, sv, sc = _bvc_strides(x, "x")
    if x.shape[1] > 1 and sc != 1:
        raise ValueError(f"GroupNorm sums kernel: x {tuple(x.shape)} with strides {x.stride()} "
                         f"does not have unit channel stride (take channels_last_3d memory)")
    return sb, sv, 1


def _count(fn, key: tuple) -> None:
    fn.launches += 1
    fn.cases[key] = fn.cases.get(key, 0) + 1


class GnPlan(NamedTuple):
    """The launch of ``ldm3d_gn_sums`` or ``ldm3d_gn_bwd_sums`` for one
    input: x's batch and voxel strides ``sb``, ``sv`` (and dy's ``dsb``,
    ``dsv``, ``dsc`` for the backward); ``vec`` elements (16 bytes, or 1) a
    load; ``ct`` channel lanes of ``rows`` voxel rows a block, which covers
    ``ct * vec`` channels; ``grid`` = (channel groups, nsplit voxel chunks of
    ``chunk``, batch); with ``cluster`` the nsplit (at most 8) blocks of a
    channel group form one thread-block cluster and add their sums in
    shared memory, else the last of them to finish adds the partials."""
    b: int
    v: int
    c: int
    sb: int
    sv: int
    vec: int
    ct: int
    rows: int
    nsplit: int
    chunk: int
    cluster: bool
    grid: tuple[int, int, int]
    dsb: int = 0
    dsv: int = 0
    dsc: int = 0


def _plan_checks(b: int, c: int, strides: tuple[int, int, int]) -> None:
    """Raises unless x has its channels minor and the grid holds the batch."""
    if strides[2] != 1 and c > 1:
        raise ValueError(f"GroupNorm sums kernel: x with strides {strides} does not have unit "
                         f"channel stride (take channels_last_3d memory)")
    if b > 65535:
        raise ValueError(f"GroupNorm sums kernel takes batch <= 65535, got {b}")


def _takes_16_bytes(b: int, per16: int, sb: int, sv: int, align: int) -> bool:
    """Whether an operand whose pointer lies ``align`` bytes past a multiple
    of 16 sits on 16 bytes at every (batch, voxel) of unit channel stride."""
    return align == 0 and sv % per16 == 0 and (b == 1 or sb % per16 == 0)


def _lanes(c: int, vec: int) -> tuple[int, int, int]:
    """(ct, rows, channel groups): 16-byte loads take 8 lanes a voxel row (one
    128-byte line), single elements 32, fewer where C is smaller."""
    ct = min(8 if vec > 1 else 32, 1 << (-(-c // vec) - 1).bit_length())
    return ct, _GN_THREADS // ct, -(-c // (ct * vec))


def gn_sums_plan(b: int, v: int, c: int, dtype: torch.dtype, strides: tuple[int, int, int],
                 align: int = 0) -> GnPlan:
    """The grid of :func:`gn_sums` for x ``(B, V, C)`` of ``dtype`` with
    element ``strides`` (batch, voxel, channel), whose data pointer lies
    ``align`` bytes past a multiple of 16: a pure function of its arguments.
    16-byte loads need unit channel stride, a 16-byte aligned pointer and
    batch and voxel strides, and a channel count that the 16 bytes divide;
    anything else reads one element a thread. Raises when the grid cannot
    hold the input."""
    sb, sv, sc = strides
    _plan_checks(b, c, strides)
    per16 = 16 // (4 if dtype == torch.float32 else 2)
    vec = per16 if c % per16 == 0 and _takes_16_bytes(b, per16, sb, sv, align) else 1
    ct, rows, groups = _lanes(c, vec)
    # chunks (measured on the H100, PERF.md): a cluster of up to 8 blocks
    # adds its sums cheaper than the last block adds partials from memory,
    # so small volumes take up to 8 chunks of at least 4 loads a thread, and
    # mid-sized ones 8 chunks where 8 a channel group fill the SMs; larger
    # ones aim at _TARGET_BLOCKS blocks of at least 8 loads a thread
    loads8 = -(-v // (8 * rows))
    if loads8 <= 16:
        nsplit = max(1, min(_GN_MAX_CLUSTER, v // (rows * 4)))
    elif b * groups * _GN_MAX_CLUSTER >= 64 and loads8 <= 64:
        nsplit = _GN_MAX_CLUSTER
    else:
        nsplit = max(1, min(-(-_TARGET_BLOCKS // (b * groups)), v // (rows * _GN_MIN_LOADS),
                            65535))
    chunk = -(-v // nsplit)
    nsplit = -(-v // chunk)  # no empty chunk
    return GnPlan(b, v, c, sb if b > 1 else 0, sv if v > 1 else 0, vec, ct, rows, nsplit, chunk,
                  1 < nsplit <= _GN_MAX_CLUSTER, (groups, nsplit, b))


def gn_bwd_sums_plan(b: int, v: int, c: int, dtype: torch.dtype,
                     x_strides: tuple[int, int, int], dy_strides: tuple[int, int, int],
                     x_align: int = 0, dy_align: int = 0) -> GnPlan:
    """The grid of :func:`gn_bwd_sums` for x and dy ``(B, V, C)`` of ``dtype``
    with element strides (batch, voxel, channel) ``x_strides`` and
    ``dy_strides``, whose data pointers lie ``x_align`` and ``dy_align`` bytes
    past a multiple of 16: a pure function of its arguments. 16-byte loads
    need both operands on 16 bytes (unit channel stride, pointer, batch and
    voxel strides) and a channel count that the 16 bytes divide; anything
    else reads one element of each a thread, dy through its three strides.
    Raises unless x has unit channel stride, or when the grid cannot hold
    the input."""
    sb, sv, _ = x_strides
    dsb, dsv, dsc = dy_strides
    _plan_checks(b, c, x_strides)
    per16 = 16 // (4 if dtype == torch.float32 else 2)
    vec = per16 if (c % per16 == 0 and dsc == 1 and _takes_16_bytes(b, per16, sb, sv, x_align)
                    and _takes_16_bytes(b, per16, dsb, dsv, dy_align)) else 1
    ct, rows, groups = _lanes(c, vec)
    # chunks: enough for _BWD_TARGET_BLOCKS blocks, each thread making at
    # least min_loads loads of each operand; a volume of at most
    # _BWD_CLUSTER_ROWS rows a thread takes 2, 4 or 8 chunks of at least 2
    # rows a thread in a cluster (faster there; slower at more rows)
    loads = -(-v // rows)
    fill = max(1, _BWD_TARGET_BLOCKS // (b * groups))
    cluster = loads <= _BWD_CLUSTER_ROWS
    if cluster:
        nsplit = 1 << (max(1, min(_GN_MAX_CLUSTER, fill, loads // 2)).bit_length() - 1)
    else:
        min_loads = _BWD_MIN_LOADS if loads > _BWD_FEW_ROWS else _BWD_FEW_MIN_LOADS
        nsplit = max(1, min(fill, loads // min_loads, 65535))
    chunk = -(-v // nsplit)
    nsplit = -(-v // chunk)  # no empty chunk
    return GnPlan(b, v, c, sb if b > 1 else 0, sv if v > 1 else 0, vec, ct, rows, nsplit, chunk,
                  cluster and nsplit > 1, (groups, nsplit, b), dsb if b > 1 else 0,
                  dsv if v > 1 else 0, dsc if c > 1 else 0)


class _Workspace:
    """Per-device state of :func:`gn_sums` and :func:`gn_bwd_sums`: the
    last-block combine's partials and arrival counters (zeros between
    calls), each grown as needed, and the ``ldm3d_gn_sums`` and
    ``ldm3d_gn_bwd_sums`` functions. Calls on one stream run in order, so
    they share them.

    A CUDA graph bakes in the buffers' pointers: a capture keeps the
    buffers it used alive (``ops.graphs.CountedGraph`` holds
    :func:`workspace_buffers`), so a later growth replaces them here
    without freeing them. Growing during a capture raises: the zeroed
    counters would be zero only once the graph ran."""

    def __init__(self):
        self.partials: dict[int, torch.Tensor] = {}
        self.counters: dict[int, torch.Tensor] = {}
        self.fn = None
        self.bwd_fn = None

    def get(self, device: torch.device, plan: GnPlan) -> tuple[torch.Tensor, torch.Tensor]:
        groups, nsplit, b = plan.grid
        partials = self.partials.get(device.index)
        counters = self.counters.get(device.index)
        grow_partials = partials is None or partials.numel() < 2 * b * nsplit * plan.c
        grow_counters = counters is None or counters.numel() < b * groups
        if (grow_partials or grow_counters) and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the GroupNorm sums workspace would grow during a CUDA graph capture (x "
                f"{(plan.b, plan.v, plan.c)}): run the captured calls once eagerly first")
        if grow_partials:
            partials = self.partials[device.index] = torch.empty(
                (max(2 * b * nsplit * plan.c, 1 << 16),), device=device)
        if grow_counters:
            counters = self.counters[device.index] = torch.zeros(
                (max(b * groups, 1 << 12),), dtype=torch.int32, device=device)
        return partials, counters


def workspace_buffers() -> list:
    """The workspace buffers the kernels now write (on every device)."""
    return [*_WS.partials.values(), *_WS.counters.values()]


_WS = _Workspace()
# plans by (shape, strides, dtype, data pointer mod 16) of x (and of dy):
# each input is checked and planned once (a model gives a few dozen; the
# dicts are emptied past 1024)
_PLANS: dict = {}
_BWD_PLANS: dict = {}


def gn_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum_v x, sum_v x^2)`` per (batch, channel), fp32 ``(B, C)`` each, for
    ``x`` ``(B, C, *spatial)``: the kernel ``ldm3d_gn_sums`` on CUDA tensors
    (one launch), :func:`gn_sums_reference` on CPU tensors."""
    if x.device.type == "cuda":
        return _gn_sums_cuda(x)
    _check(x)
    if x.device.type == "cpu":
        return gn_sums_reference(x)
    raise ValueError(f"GroupNorm sums run on cuda (kernel) or cpu (plain), not {x.device}")


def _gn_sums_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    device = x.device
    if device.index != torch.cuda.current_device():  # launch on x's device's stream
        with torch.cuda.device(device):
            return _gn_sums_cuda(x)
    shape, stride = x.shape, x.stride()
    key = (shape, stride, x.dtype, x.data_ptr() % 16)
    plan = _PLANS.get(key)
    if plan is None:
        b, v, c = _check(x)
        if x.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"GroupNorm sums kernels take float32 or bfloat16, got {x.dtype}")
        if len(_PLANS) >= 1024:
            _PLANS.clear()
        plan = _PLANS[key] = gn_sums_plan(b, v, c, x.dtype, _x_strides(x), key[3])
    out = torch.empty((2, plan.b, plan.c), dtype=torch.float32, device=device)
    partials, counters = _WS.get(device, plan)
    if _WS.fn is None:
        from ldm3d_torch.ops._kernels import groupnorm_library

        _WS.fn = groupnorm_library().ldm3d_gn_sums
    err = _WS.fn(x.data_ptr(), out.data_ptr(), partials.data_ptr(), counters.data_ptr(),
                 int(x.dtype == torch.bfloat16), plan.b, plan.v, plan.c, plan.sb, plan.sv,
                 plan.vec, plan.ct, plan.nsplit, plan.chunk, int(plan.cluster),
                 torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"gn_sums kernel launch failed with cudaError {err} for "
                           f"x {tuple(shape)} strides {stride} {x.dtype}")
    _count(gn_sums, (tuple(shape), _DTYPE_NAMES[x.dtype], stride))
    return out.unbind(0)


gn_sums.launches = 0
gn_sums.cases = {}


def gn_bwd_sums(dy: torch.Tensor, x: torch.Tensor, mean_c: torch.Tensor,
                inv_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum_v dy, sum_v dy * x_hat)`` per (batch, channel), fp32 ``(B, C)``
    each, with ``x_hat = (x - mean_c) * inv_c`` formed on the fly: the kernel
    ``ldm3d_gn_bwd_sums`` on CUDA tensors (one launch),
    :func:`gn_bwd_sums_reference` on CPU tensors. ``dy`` may have another
    memory layout than ``x``; on the card ``x`` is channels minor."""
    if x.device.type == "cuda":
        return _gn_bwd_sums_cuda(dy, x, mean_c, inv_c)
    _bwd_checks(dy, x, mean_c, inv_c)
    if x.device.type == "cpu":
        return gn_bwd_sums_reference(dy, x, mean_c, inv_c)
    raise ValueError(f"GroupNorm sums run on cuda (kernel) or cpu (plain), not {x.device}")


def _bwd_checks(dy: torch.Tensor, x: torch.Tensor, mean_c: torch.Tensor,
                inv_c: torch.Tensor) -> tuple[int, int, int]:
    """(B, V, C); raises unless dy matches x and mean_c, inv_c are fp32
    (B, C) on x's device, contiguous where that is the card."""
    b, v, c = _check(x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: got {tuple(dy.shape)} {dy.dtype} {dy.device}, "
                         f"x {tuple(x.shape)} {x.dtype} {x.device}")
    for name, t in (("mean_c", mean_c), ("inv_c", inv_c)):
        if t.shape != (b, c) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be fp32 (batch, channels) = {(b, c)} on {x.device}; "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
    if x.device.type == "cuda" and not (mean_c.is_contiguous() and inv_c.is_contiguous()):
        raise ValueError("mean_c and inv_c must be contiguous")
    return b, v, c


def _gn_bwd_sums_cuda(dy: torch.Tensor, x: torch.Tensor, mean_c: torch.Tensor,
                      inv_c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    device = x.device
    if device.index != torch.cuda.current_device():  # launch on x's device's stream
        with torch.cuda.device(device):
            return _gn_bwd_sums_cuda(dy, x, mean_c, inv_c)
    plan = gn_bwd_sums_plan_of(dy, x, mean_c, inv_c)
    bc = (plan.b, plan.c)
    for t in (mean_c, inv_c):
        if not (t.shape == bc and t.dtype == torch.float32 and t.device == device
                and t.is_contiguous()):
            _bwd_checks(dy, x, mean_c, inv_c)
    out = torch.empty((2, plan.b, plan.c), dtype=torch.float32, device=device)
    err = _launch_bwd_sums(plan, dy.data_ptr(), x.data_ptr(), mean_c, inv_c, out, x.dtype, device)
    shape, stride, dstride = x.shape, x.stride(), dy.stride()
    if err != 0:
        raise RuntimeError(f"gn_bwd_sums kernel launch failed with cudaError {err} for "
                           f"x {tuple(shape)} strides {stride}, dy strides {dstride} {x.dtype}")
    _count(gn_bwd_sums, (tuple(shape), _DTYPE_NAMES[x.dtype], stride, dstride))
    return out.unbind(0)


def gn_bwd_sums_plan_of(dy: torch.Tensor, x: torch.Tensor, mean_c: torch.Tensor,
                        inv_c: torch.Tensor, cached: bool = True) -> GnPlan:
    """The plan :func:`gn_bwd_sums` launches on these CUDA tensors: looked
    up by (shape, strides, dtype, data pointer mod 16) of x and of dy, and
    on a miss (or with ``cached`` false) made after every check of the
    arguments."""
    xp, dp = x.data_ptr(), dy.data_ptr()
    key = (x.shape, x.stride(), dy.shape, dy.stride(), x.dtype, dy.dtype, dy.device == x.device,
           xp % 16, dp % 16)
    plan = _BWD_PLANS.get(key) if cached else None
    if plan is None:
        b, v, c = _bwd_checks(dy, x, mean_c, inv_c)
        if x.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"GroupNorm sums kernels take float32 or bfloat16, got {x.dtype}")
        plan = gn_bwd_sums_plan(b, v, c, x.dtype, _x_strides(x), _bvc_strides(dy, "dy"),
                                xp % 16, dp % 16)
        if cached:
            if len(_BWD_PLANS) >= 1024:
                _BWD_PLANS.clear()
            _BWD_PLANS[key] = plan
    return plan


def _launch_bwd_sums(plan: GnPlan, dp: int, xp: int, mean_c: torch.Tensor, inv_c: torch.Tensor,
                     out: torch.Tensor, dtype: torch.dtype, device: torch.device) -> int:
    """``ldm3d_gn_bwd_sums`` under ``plan`` on dy and x at data pointers
    ``dp``, ``xp``, into ``out`` (2, B, C) fp32, on the current stream;
    returns its cudaError_t."""
    partials, counters = _WS.get(device, plan)
    if _WS.bwd_fn is None:
        from ldm3d_torch.ops._kernels import groupnorm_library

        _WS.bwd_fn = groupnorm_library().ldm3d_gn_bwd_sums
    return _WS.bwd_fn(dp, xp, mean_c.data_ptr(), inv_c.data_ptr(), out.data_ptr(),
                      partials.data_ptr(), counters.data_ptr(), int(dtype == torch.bfloat16),
                      plan.b, plan.v, plan.c, plan.sb, plan.sv, plan.dsb, plan.dsv, plan.dsc,
                      plan.vec, plan.ct, plan.nsplit, plan.chunk, int(plan.cluster),
                      torch._C._cuda_getCurrentRawStream(device.index))


gn_bwd_sums.launches = 0
gn_bwd_sums.cases = {}
