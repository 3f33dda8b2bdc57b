"""Implicit-GEMM 3x3x3 convolution for lane-starved channel widths (C <= 64).

Counterpart of ``ldm3d_tpu/ops/conv3d.py``: :func:`conv3d_igemm` computes a
SAME, stride-1 3x3x3 convolution of ``x`` (B, D, H, W, C), NDHWC, with ``w``
(3, 3, 3, C, Cout), DHWIO, accumulated in fp32 and returned in ``x``'s dtype.
It raises ``ValueError`` on the shapes the JAX kernel does not target (a
kernel other than 3x3x3, C > 64, W not a multiple of 8), with the same
messages. The JAX ``tile_m`` and ``interpret`` arguments are TPU knobs and
are not taken.

On CUDA tensors it launches the hand-written kernel of
``csrc/conv3d_igemm.cu`` (which replaces the TPU's ``_kernel``,
``ldm3d_tpu/ops/conv3d.py:58``); on CPU tensors it runs the plain version
:func:`conv3d_ref`; any other device raises. Launches are counted in
``conv3d_igemm.launches``. As in the JAX package there is no gradient (a
tensor that requires grad raises) and no model path calls it: its entry
point is the A/B tool ``ldm3d_torch/tools/conv_ab.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv3d_igemm", "conv3d_ref"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def conv3d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: zero-pad by one voxel, add the 27 shifted-slice
    products ``x_tap @ w[kd, kh, kw]`` in fp32, cast to ``x.dtype`` (as
    ``conv3d_xla``'s ``preferred_element_type=float32``)."""
    B, D, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                tap = xp[:, kd:kd + D, kh:kh + H, kw:kw + W] @ wf[kd, kh, kw]
                acc = tap if acc is None else acc.add_(tap)
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"conv3d_igemm takes x (B, D, H, W, C), got {tuple(x.shape)}")
    C = x.shape[4]
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[3] != C:
        raise ValueError(f"conv3d_igemm targets 3x3x3 kernels, got {tuple(w.shape)}")
    if C > 64:
        raise ValueError(f"conv3d_igemm targets lane-starved C <= 64, got {C}")
    if x.shape[3] % 8:
        raise ValueError(f"conv3d_igemm needs W % 8 == 0 (alignment), got {x.shape[3]}")
    if x.requires_grad or w.requires_grad:
        raise ValueError("conv3d_igemm has no gradient (as in the JAX package); "
                         "call it on tensors that do not require grad")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"w must match x's dtype and device: x {x.dtype} {x.device}, "
                         f"w {w.dtype} {w.device}")


def conv3d_igemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3x3 stride-1 conv, (B, D, H, W, C) x (3, 3, 3, C, Cout), C <= 64:
    the kernel ``ldm3d_conv3d_igemm`` on CUDA tensors, :func:`conv3d_ref` on
    CPU tensors."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3d_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_igemm runs on cuda (kernel) or cpu (plain), not {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the conv3d_igemm kernel takes float32 or bfloat16, got {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the conv3d_igemm kernel takes contiguous NDHWC x and DHWIO w")
    B, D, H, W, C = x.shape
    cout = w.shape[4]
    if B * D > 65535:
        raise ValueError(f"the conv3d_igemm kernel takes B * D <= 65535, got {B * D}")
    from ldm3d_torch.ops._kernels import conv3d_library

    y = torch.empty((B, D, H, W, cout), dtype=x.dtype, device=x.device)
    lib = conv3d_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ldm3d_conv3d_igemm(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                     int(x.dtype == torch.bfloat16), B, D, H, W, C, cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_igemm kernel launch failed with cudaError {err} for "
                           f"x {tuple(x.shape)} w {tuple(w.shape)} {x.dtype}")
    conv3d_igemm.launches += 1
    return y


conv3d_igemm.launches = 0
