"""Volumetric self-attention over flattened D*H*W tokens, with its gradient.

Shapes follow the JAX package: q, k, v are ``(batch, tokens, heads, head_dim)``.

:func:`volumetric_attention` is :class:`FlashAttention`, a
``torch.autograd.Function``: its forward saves ``(q, k, v, O, LSE)`` as the
JAX custom VJP does (``ldm3d_tpu/ops/attention.py:373-375``), and its backward
computes D = rowsum(dO * O) in fp32 as plain torch (outside any kernel in JAX
too, ``:305-307``), then dQ and dK/dV.

On CUDA tensors every step runs a hand-written kernel: the forward
``csrc/flash_fwd.cu``, the backward ``csrc/flash_bwd.cu`` (two kernels, dQ
and dK/dV); if one cannot run (no ``nvcc``, a shape it does not take, a
failed launch) the call raises. On CPU tensors each wrapper runs its plain
PyTorch version of the same fp32 math (:func:`attention_reference`,
:func:`attention_bwd_dq_reference`, :func:`attention_bwd_dkv_reference`).
Any other device raises. There is no switch between the two. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

Kernel notes. ``flash_fwd.cu`` replaces the TPU's ``_flash_kernel_mono`` and
``_flash_kernel`` (``ldm3d_tpu/ops/attention.py:49`` and ``:83``);
``flash_bwd.cu`` replaces ``_flash_dq_kernel`` (``:122``) and
``_flash_dkv_kernel`` (``:150``). At the shapes that carry the models'
attention time the work (4, 6 and 8 n·kv·d flops) is compute-bound on the
H100. Up to head_dim 256 each kernel takes one route per dtype. bf16 runs
FlashAttention-2 on the tensor cores (``mma.sync``, fp32 accumulators): the
forward rounds P to bf16 before P·V; the backward splits P and dS into two
bf16 parts (hi and the rounded remainder lo) and multiplies each, so that its
gradients stay within one bf16 ulp of the largest |grad|. In fp32 the
forward and both backward kernels run the same loops on the tensor cores in
TF32, each operand split into a TF32 hi and lo part and three products
(3xTF32), which reads as full fp32 (the backward adds each tile's products
into its fp32 accumulators once, in round-to-nearest, since the tensor cores
truncate each product's sum). Above head_dim 256 both dtypes take a plain
scalar route that splits the output's head dims over a grid axis. See the
sources' headers and ``PERF.md``.

Head widths. :func:`volumetric_attention` zero-pads head_dim to the next
multiple of 8 outside :class:`FlashAttention` and slices O afterwards, as the
TPU path's ``_pad_heads`` does (``ldm3d_tpu/ops/attention.py:402``), so that
autograd differentiates the pad and the slice; the true 1/sqrt(d) reaches
every wrapper and kernel as the ``scale`` argument. The kernel wrappers
themselves take any head_dim (on the card they pad a width that is not a
multiple of 8 the same way), any token count and any batch*heads. The bf16
kernels copy rows in 16-byte pieces, so their q, k, v (and dO) must start on
16 bytes and have strides of whole 16 bytes: views of a fused qkv with a
head_dim that is a multiple of 8 do; anything else raises
(:func:`check_16_byte_rows`), and nothing is copied.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

__all__ = ["FlashAttention", "attention_reference", "attention_bwd_reference",
           "attention_bwd_dq_reference", "attention_bwd_dkv_reference", "attention_bwd_dvec",
           "check_16_byte_rows", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "volumetric_attention"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _pad8(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each tensor with its head dim zero-padded to the next multiple of 8."""
    pad = -ts[0].shape[-1] % 8
    return ts if not pad else tuple(F.pad(t, (0, pad)) for t in ts)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None):
    """Plain PyTorch attention, fp32 math: returns ``(O, LSE)`` with O
    ``(B, n, h, d)`` in the input dtype and LSE ``(B*h, n)`` in fp32. The
    logits are scaled by ``scale``, by default 1/sqrt(head_dim)."""
    b, n, h, d = q.shape
    scale = _scale(q, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse.reshape(b * h, n)


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (batch, tokens, heads, head_dim); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k and v must be (batch, kv_tokens, {h}, {d}); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(b, n, h, d, k.shape[1]) == 0:
        raise ValueError(f"empty attention input: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")


def check_16_byte_rows(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` naming ``t`` unless its data pointer, and the
    stride in bytes of each of its (batch, tokens, heads) dims longer than
    one, are multiples of 16: the bf16 kernels copy head_dim rows to shared
    memory in 16-byte pieces (``cp.async``)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the bf16 flash kernel; "
                         f"its data pointer is {t.data_ptr() % 16} bytes past one")
    for dim, (size, stride) in enumerate(zip(t.shape[:3], t.stride()[:3])):
        if size > 1 and (stride * t.element_size()) % 16:
            raise ValueError(f"{name} must have strides of whole 16 bytes for the bf16 flash "
                             f"kernel; dim {dim} has {stride * t.element_size()} bytes "
                             f"(strides {t.stride()})")


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; it routes by dtype
    and head_dim."""
    from ldm3d_torch.ops._kernels import flash_fwd_library

    b, n, h, d = q.shape
    kv_len = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if d % 8:  # the kernels take whole 8-column head-dim tiles
        out, lse = _flash_fwd_cuda(*_pad8(q, k, v), scale)
        return out[..., :d], lse
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on head_dim, got strides {t.stride()}")
        if q.dtype == torch.bfloat16:
            check_16_byte_rows(name, t)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(q.stride(0), q.stride(1), q.stride(2),
                                   k.stride(0), k.stride(1), k.stride(2),
                                   v.stride(0), v.stride(1), v.stride(2))
    lib = flash_fwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ldm3d_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  lse.data_ptr(), int(q.dtype == torch.bfloat16), b, h, n,
                                  kv_len, d, strides, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed with cudaError {err} for "
                           f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None):
    """Attention forward returning ``(O, LSE)``: the CUDA kernel on CUDA
    tensors, :func:`attention_reference` on CPU tensors. ``scale`` multiplies
    the logits, by default 1/sqrt(head_dim).

    ``flash_attention_fwd.launches`` counts kernel launches (and only those).
    """
    _check_inputs(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    raise ValueError(f"attention runs on cuda (kernel) or cpu (plain), not {q.device}")


flash_attention_fwd.launches = 0


def _probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, scale: float) -> torch.Tensor:
    """P = exp(scale * q k^T - LSE) in fp32, ``(B, h, n, kv)``."""
    b, n, h, _ = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.exp(logits - lse.reshape(b, h, n)[..., None])


def _dscores(q, k, v, do, lse, dvec, scale):
    """(P, dS) with dS = P * (dO v^T - D), fp32, ``(B, h, n, kv)``."""
    b, n, h, _ = q.shape
    p = _probs(q, k, lse, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - dvec.reshape(b, h, n)[..., None])


def attention_bwd_dq_reference(q, k, v, do, lse, dvec, scale=None):
    """Plain PyTorch dQ = scale * dS k (fp32 math, input dtype out), from the
    forward's LSE and D = rowsum(dO * O), both ``(B*h, n)`` fp32; ``scale``
    as the forward's, by default 1/sqrt(head_dim)."""
    scale = _scale(q, scale)
    _, ds = _dscores(q, k, v, do, lse, dvec, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def attention_bwd_dkv_reference(q, k, v, do, lse, dvec, scale=None):
    """Plain PyTorch dK = scale * dS^T q and dV = P^T dO (fp32 math, input
    dtype out); arguments as :func:`attention_bwd_dq_reference`."""
    scale = _scale(q, scale)
    p, ds = _dscores(q, k, v, do, lse, dvec, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_dvec(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, ``(B*h, n)`` contiguous."""
    b, n, h, _ = o.shape
    # at batch 1 the transposed (1, h, n) reshapes to a strided view: copy it
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().reshape(b * h, n)


def attention_bwd_reference(q, k, v, o, lse, do, scale=None):
    """Plain PyTorch FlashAttention-2 backward: ``(dq, dk, dv)`` from the
    forward's inputs, output O and LSE, and dO."""
    dvec = attention_bwd_dvec(do, o)
    return (attention_bwd_dq_reference(q, k, v, do, lse, dvec, scale),
            *attention_bwd_dkv_reference(q, k, v, do, lse, dvec, scale))


def _check_bwd_inputs(q, k, v, do, lse, dvec) -> None:
    _check_inputs(q, k, v)
    b, n, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: got {tuple(do.shape)} {do.dtype} {do.device}, "
                         f"q {tuple(q.shape)} {q.dtype} {q.device}")
    for name, t in (("lse", lse), ("D", dvec)):
        if t.shape != (b * h, n) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be fp32 (batch*heads, tokens) = {(b * h, n)} on "
                             f"{q.device}; got {tuple(t.shape)} {t.dtype} {t.device}")


def _bwd_kernel_args(q, k, v, do, lse, dvec):
    """Checks shared by the two backward kernels (in bf16, the 16-byte rows
    of q, k, v and dO); returns their ctypes strides."""
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash backward kernels take float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on head_dim, got strides {t.stride()}")
        if q.dtype == torch.bfloat16:
            check_16_byte_rows(name, t)
    for name, t in (("lse", lse), ("D", dvec)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return (ctypes.c_int64 * 12)(*(s for t in (q, k, v, do) for s in t.stride()[:3]))


def flash_attention_bwd_dq(q, k, v, do, lse, dvec, scale=None):
    """dQ of attention: the kernel ``ldm3d_flash_bwd_dq`` of ``csrc/flash_bwd.cu``
    on CUDA tensors, :func:`attention_bwd_dq_reference` on CPU tensors; ``scale``
    as the forward's. ``flash_attention_bwd_dq.launches`` counts kernel launches."""
    _check_bwd_inputs(q, k, v, do, lse, dvec)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return attention_bwd_dq_reference(q, k, v, do, lse, dvec, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda (kernel) or cpu (plain), not {q.device}")
    from ldm3d_torch.ops._kernels import flash_bwd_library

    b, n, h, d = q.shape
    if d % 8:
        return flash_attention_bwd_dq(*_pad8(q, k, v, do), lse, dvec, scale)[..., :d]
    strides = _bwd_kernel_args(q, k, v, do, lse, dvec)
    dq = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = flash_bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ldm3d_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                     lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
                                     int(q.dtype == torch.bfloat16), b, h, n, k.shape[1], d,
                                     strides, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dQ kernel launch failed with cudaError {err} for "
                           f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, dvec, scale=None):
    """(dK, dV) of attention: the kernel ``ldm3d_flash_bwd_dkv`` of
    ``csrc/flash_bwd.cu`` on CUDA tensors, :func:`attention_bwd_dkv_reference`
    on CPU tensors; ``scale`` as the forward's.
    ``flash_attention_bwd_dkv.launches`` counts kernel launches."""
    _check_bwd_inputs(q, k, v, do, lse, dvec)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return attention_bwd_dkv_reference(q, k, v, do, lse, dvec, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda (kernel) or cpu (plain), not {q.device}")
    from ldm3d_torch.ops._kernels import flash_bwd_library

    b, n, h, d = q.shape
    if d % 8:
        dk, dv = flash_attention_bwd_dkv(*_pad8(q, k, v, do), lse, dvec, scale)
        return dk[..., :d], dv[..., :d]
    kv_len = k.shape[1]
    strides = _bwd_kernel_args(q, k, v, do, lse, dvec)
    dk = torch.empty((b, kv_len, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, kv_len, h, d), dtype=v.dtype, device=v.device)
    lib = flash_bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ldm3d_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                      lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(),
                                      dv.data_ptr(), int(q.dtype == torch.bfloat16), b, h, n,
                                      kv_len, d, strides, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd dK/dV kernel launch failed with cudaError {err} for "
                           f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, scale=None):
    """Attention backward ``(dq, dk, dv)``: D = rowsum(dO * O) in fp32, then
    :func:`flash_attention_bwd_dq` and :func:`flash_attention_bwd_dkv`."""
    dvec = attention_bwd_dvec(do, o)
    return (flash_attention_bwd_dq(q, k, v, do, lse, dvec, scale),
            *flash_attention_bwd_dkv(q, k, v, do, lse, dvec, scale))


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: the forward kernel, and the FlashAttention-2
    backward that rebuilds each tile of P from the saved LSE instead of
    keeping the (tokens x tokens) matrix."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum()
            do = do.contiguous()
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.scale), None)


def volumetric_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention over volumetric tokens, ``(B, n, h, d)`` in and out;
    differentiable through :class:`FlashAttention`. A head_dim that is not a
    multiple of 8 is zero-padded to one outside it (zero columns of q and k
    add nothing to the logits, zero columns of v give zero columns of O,
    sliced off), at the true 1/sqrt(d)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    if d % 8 == 0:
        return FlashAttention.apply(q, k, v, scale)
    return FlashAttention.apply(*_pad8(q, k, v), scale)[..., :d]
