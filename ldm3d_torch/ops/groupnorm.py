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
:func:`gn_bwd_sums_reference`. Any other device raises. Each wrapper counts
its launches in ``<wrapper>.launches`` (one per call of the C entry point,
which runs a split pass and a fixed-order combine pass), and by input in
``<wrapper>.cases``: a dict from ``(shape, dtype, strides of x[, strides of
dy])`` to launches, from which a caller can rebuild the exact inputs a run
gave the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["gn_sums", "gn_bwd_sums", "gn_sums_reference", "gn_bwd_sums_reference"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# blocks the split pass aims for (about 8 per SM of an H100), and the fewest
# voxels one block reduces
_TARGET_BLOCKS = 1024
_MIN_CHUNK = 256


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
    """Kernel arguments shared by both sums: sizes, splits, outputs and
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


def gn_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum_v x, sum_v x^2)`` per (batch, channel), fp32 ``(B, C)`` each, for
    ``x`` ``(B, C, *spatial)``: the kernel ``ldm3d_gn_sums`` on CUDA tensors,
    :func:`gn_sums_reference` on CPU tensors."""
    _check(x)
    if x.device.type == "cpu":
        return gn_sums_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"GroupNorm sums run on cuda (kernel) or cpu (plain), not {x.device}")
    from ldm3d_torch.ops._kernels import groupnorm_library

    strides = (ctypes.c_int64 * 3)(*_x_strides(x))
    b, v, c, nsplit, s1, s2, scratch = _launch_setup(x)
    lib = groupnorm_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ldm3d_gn_sums(x.data_ptr(), s1.data_ptr(), s2.data_ptr(), scratch.data_ptr(),
                                int(x.dtype == torch.bfloat16), b, v, c, strides, nsplit,
                                stream)
    if err != 0:
        raise RuntimeError(f"gn_sums kernel launch failed with cudaError {err} for "
                           f"x {tuple(x.shape)} strides {x.stride()} {x.dtype}")
    _count(gn_sums, (tuple(x.shape), _dtype_name(x), x.stride()))
    return s1, s2


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
