"""Volumetric self-attention over flattened D*H*W tokens.

Shapes follow the JAX package: q, k, v are ``(batch, tokens, heads, head_dim)``.

On a CUDA tensor the attention runs through the hand-written flash-attention
forward kernel ``csrc/flash_fwd.cu``; if it cannot (no ``nvcc``, a shape it
does not take, a failed launch) the call raises. On a CPU tensor it runs
:func:`attention_reference`, the plain PyTorch version of the same fp32 math.
Any other device raises. There is no switch between the two.

Kernel note. ``flash_fwd.cu`` replaces the TPU's ``_flash_kernel_mono`` and
``_flash_kernel`` (``ldm3d_tpu/ops/attention.py:49`` and ``:83``) with one
kernel. At the shapes that carry the models' attention time the work
(4·n·kv·d flops) is compute-bound on the H100; the kernel is a scalar-fp32
FMA design that streams k/v tiles through shared memory with the online
softmax in registers, exact to fp32 summation order, and far from the bf16
tensor-core bound (see the source's header and ``PERF.md``). The TPU path's ``_pad_heads`` lane padding has no
counterpart: the kernel takes any head_dim that is a multiple of 8 up to 256
at the true 1/sqrt(d) scale, and any token count.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["attention_reference", "flash_attention_fwd", "volumetric_attention"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch attention, fp32 math: returns ``(O, LSE)`` with O
    ``(B, n, h, d)`` in the input dtype and LSE ``(B*h, n)`` in fp32."""
    b, n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
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


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    from ldm3d_torch.ops._kernels import flash_fwd_library

    b, n, h, d = q.shape
    kv_len = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"flash kernel takes head_dim a multiple of 8 up to 256, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash kernel takes batch*heads <= 65535, got {b * h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on head_dim, got strides {t.stride()}")
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
                                  kv_len, d, strides, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed with cudaError {err} for "
                           f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Attention forward returning ``(O, LSE)``: the CUDA kernel on CUDA
    tensors, :func:`attention_reference` on CPU tensors.

    ``flash_attention_fwd.launches`` counts kernel launches (and only those).
    """
    _check_inputs(q, k, v)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    raise ValueError(f"attention runs on cuda (kernel) or cpu (plain), not {q.device}")


flash_attention_fwd.launches = 0


def volumetric_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention over volumetric tokens, ``(B, n, h, d)`` in and out."""
    return flash_attention_fwd(q, k, v)[0]
