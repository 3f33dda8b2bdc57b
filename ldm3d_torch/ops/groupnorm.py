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
:func:`gn_bwd_sums_reference`. Any other device raises. :func:`gn_sums` is one
kernel launch a call: each block sums a chunk of voxels and the last block of
a (batch, channel group) to finish adds the chunks' partials in a fixed order
(:func:`gn_sums_plan` lays out the grid); :func:`gn_bwd_sums` runs a split
pass and a fixed-order combine pass. Each wrapper counts its calls of the C
entry point in ``<wrapper>.launches``, and by input in ``<wrapper>.cases``: a
dict from ``(shape, dtype, strides of x[, strides of dy])`` to launches, from
which a caller can rebuild the exact inputs a run gave the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

__all__ = ["GnPlan", "gn_sums", "gn_sums_plan", "gn_bwd_sums", "gn_sums_reference",
           "gn_bwd_sums_reference"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# blocks a call aims for at large inputs (about 8 per SM of an H100), and
# the fewest voxels a block of the backward's split pass reduces
_TARGET_BLOCKS = 1024
_MIN_CHUNK = 256
# threads of a gn_sums block (csrc/groupnorm_sums.cu GN_NT), and the fewest
# loads each of its threads makes (more blocks for a small volume would only
# add partials)
_GN_THREADS = 256
_GN_MIN_LOADS = 8
# the most blocks a portable thread-block cluster holds
_GN_MAX_CLUSTER = 8


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


def _launch_setup(x: torch.Tensor):
    """Kernel arguments of the backward sums: sizes, splits, outputs and
    scratch (one allocation)."""
    b, v, c = _check(x)
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"GroupNorm sums kernels take float32 or bfloat16, got {x.dtype}")
    if b > 65535 or c > 65535:
        raise ValueError(f"GroupNorm sums kernels take batch and channels <= 65535, got {b}, {c}")
    nsplit = max(1, min(-(-_TARGET_BLOCKS // (b * -(-c // 32))), v // _MIN_CHUNK))
    buf = torch.empty((2 * b * c * (1 + nsplit),), dtype=torch.float32, device=x.device)
    s1, s2 = buf[:b * c].view(b, c), buf[b * c:2 * b * c].view(b, c)
    return b, v, c, nsplit, s1, s2, buf[2 * b * c:]


def _count(fn, key: tuple) -> None:
    fn.launches += 1
    fn.cases[key] = fn.cases.get(key, 0) + 1


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class GnPlan(NamedTuple):
    """The launch of ``ldm3d_gn_sums`` for one input: ``vec`` elements (16
    bytes, or 1) a load; ``ct`` channel lanes of ``rows`` voxel rows a block,
    which covers ``ct * vec`` channels; ``grid`` = (channel groups, nsplit
    voxel chunks of ``chunk``, batch); with ``cluster`` the nsplit blocks of
    a channel group form one thread-block cluster and add their sums in
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
    if sc != 1 and c > 1:
        raise ValueError(f"GroupNorm sums kernel: x with strides {strides} does not have unit "
                         f"channel stride (take channels_last_3d memory)")
    if b > 65535:
        raise ValueError(f"GroupNorm sums kernel takes batch <= 65535, got {b}")
    per16 = 16 // (4 if dtype == torch.float32 else 2)
    vec = per16 if (align == 0 and c % per16 == 0 and sv % per16 == 0
                    and (b == 1 or sb % per16 == 0)) else 1
    # 16-byte loads: 8 lanes a voxel row read one 128-byte line; else 32 lanes
    ct = min(8 if vec > 1 else 32, 1 << (-(-c // vec) - 1).bit_length())
    rows = _GN_THREADS // ct
    groups = -(-c // (ct * vec))
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


class _Workspace:
    """Per-device state of :func:`gn_sums`: the last-block combine's partials
    and arrival counters (zeros between calls), each grown as needed, and
    the ``ldm3d_gn_sums`` function. Calls on one stream run in order, so
    they share them."""

    def __init__(self):
        self.partials: dict[int, torch.Tensor] = {}
        self.counters: dict[int, torch.Tensor] = {}
        self.fn = None

    def get(self, device: torch.device, plan: GnPlan) -> tuple[torch.Tensor, torch.Tensor]:
        groups, nsplit, b = plan.grid
        partials = self.partials.get(device.index)
        if partials is None or partials.numel() < 2 * b * nsplit * plan.c:
            partials = self.partials[device.index] = torch.empty(
                (max(2 * b * nsplit * plan.c, 1 << 16),), device=device)
        counters = self.counters.get(device.index)
        if counters is None or counters.numel() < b * groups:
            counters = self.counters[device.index] = torch.zeros(
                (max(b * groups, 1 << 12),), dtype=torch.int32, device=device)
        return partials, counters


_WS = _Workspace()
# plans by (shape, strides, dtype, data pointer mod 16): each input is checked
# and planned once (a model gives a few dozen; the dict is emptied past 1024)
_PLANS: dict = {}


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
    ``ldm3d_gn_bwd_sums`` on CUDA tensors, :func:`gn_bwd_sums_reference` on CPU
    tensors. ``dy`` may have another memory layout than ``x``; on the card
    ``x`` is channels minor."""
    b, _, c = _check(x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: got {tuple(dy.shape)} {dy.dtype} {dy.device}, "
                         f"x {tuple(x.shape)} {x.dtype} {x.device}")
    for name, t in (("mean_c", mean_c), ("inv_c", inv_c)):
        if t.shape != (b, c) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be fp32 (batch, channels) = {(b, c)} on {x.device}; "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
    if x.device.type == "cpu":
        return gn_bwd_sums_reference(dy, x, mean_c, inv_c)
    if x.device.type != "cuda":
        raise ValueError(f"GroupNorm sums run on cuda (kernel) or cpu (plain), not {x.device}")
    if not (mean_c.is_contiguous() and inv_c.is_contiguous()):
        raise ValueError("mean_c and inv_c must be contiguous")
    from ldm3d_torch.ops._kernels import groupnorm_library

    strides = (ctypes.c_int64 * 6)(*_x_strides(x), *_bvc_strides(dy, "dy"))
    b, v, c, nsplit, s1, s2, scratch = _launch_setup(x)
    lib = groupnorm_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ldm3d_gn_bwd_sums(dy.data_ptr(), x.data_ptr(), mean_c.data_ptr(),
                                    inv_c.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                                    scratch.data_ptr(), int(x.dtype == torch.bfloat16), b, v, c,
                                    strides, nsplit, stream)
    if err != 0:
        raise RuntimeError(f"gn_bwd_sums kernel launch failed with cudaError {err} for "
                           f"x {tuple(x.shape)} strides {x.stride()}, dy strides {dy.stride()} "
                           f"{x.dtype}")
    _count(gn_bwd_sums, (tuple(x.shape), _dtype_name(x), x.stride(), dy.stride()))
    return s1, s2


gn_bwd_sums.launches = 0
gn_bwd_sums.cases = {}
