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
counts its kernel launches in ``<wrapper>.launches``, by route in
``<wrapper>.route_launches`` and by input in ``<wrapper>.cases`` (a dict from
``(q's shape, kv_len, dtype name)`` to launches).

Kernel notes. ``flash_fwd.cu`` replaces the TPU's ``_flash_kernel_mono`` and
``_flash_kernel`` (``ldm3d_tpu/ops/attention.py:49`` and ``:83``);
``flash_bwd.cu`` replaces ``_flash_dq_kernel`` (``:122``) and
``_flash_dkv_kernel`` (``:150``). At the shapes that carry the models'
attention time the work (4, 6 and 8 n·kv·d flops) is compute-bound on the
H100. Up to head_dim 256 each kernel takes one route for fp32 and two for
bf16. bf16 runs FlashAttention-2 on the tensor cores with fp32
accumulators: the forward on ``mma.sync`` up to head_dim 128 and on Hopper's
warpgroup products (``wgmma``) above it, over tiles that the Tensor Memory
Accelerator (TMA) loads; the backward the other way round, on ``wgmma`` up
to head_dim 128 and on ``mma.sync`` above it (:func:`flash_fwd_plan` and
:func:`flash_bwd_plan` give each route's launch plan and the ``wgmma``
routes' tensor maps). The forward rounds P to bf16
before P·V; the backward splits P and dS into two
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

__all__ = ["BWD_ROUTE_IDS", "FWD_ROUTE_IDS", "FlashAttention", "attention_reference",
           "attention_bwd_reference", "attention_bwd_dq_reference", "attention_bwd_dkv_reference",
           "attention_bwd_dvec", "bwd_route_id", "check_16_byte_rows", "flash_attention_fwd",
           "flash_bwd_plan", "flash_fwd_plan", "fwd_route_id", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "volumetric_attention"]

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


# The forward's routes (csrc/flash_fwd.cu), in the order of the route ids of
# ``ldm3d_flash_fwd_plan``: bf16 up to d = 128 on mma.sync, bf16 at
# 128 < d <= 256 on wgmma with TMA, fp32 up to 256 on 3xTF32 mma.sync, and
# either dtype above 256 on the scalar wide kernel.
FWD_ROUTE_IDS = ("bf16", "bf16_wgmma", "fp32", "wide")
# (query rows a block, threads, dynamic shared memory by the DMAX of d)
_FWD_TILES = {"bf16": (128, 256, {64: 55296, 128: 104448}),
              "bf16_wgmma": (128, 256, {256: 64 * 1024 + 4 * 32 * 1024 + 128 + 1024}),
              "fp32": (128, 256, {64: 110592, 128: 208896, 256: 202752}),
              "wide": (64, 256, {})}
_WG_BOX_DIMS, _WG_KV_ROWS = 64, 64


def _tensor_map(rows: int, h: int, b: int, d: int, strides, box_rows: int) -> dict:
    """The TMA tensor map the wgmma route encodes for a (b, rows, h, d) bf16
    view with element strides ``strides`` (batch, tokens, heads): dims
    innermost first, strides in bytes of dims 1-3 (a dim of size one gets a
    whole-16-byte stride: it is never stepped), a box of 64 head dims x
    ``box_rows`` rows, the 128-byte swizzle."""
    r16 = lambda x: -(-x // 16) * 16  # noqa: E731
    sb, sn, sh = (2 * s for s in strides)
    if rows == 1:
        sn = r16(2 * d)
    if h == 1:
        sh = r16(sn * rows)
    if b == 1:
        sb = r16(sh * h)
    return {"dims": (d, rows, h, b), "strides_bytes": (sn, sh, sb),
            "box": (_WG_BOX_DIMS, box_rows, 1, 1), "element_bytes": 2, "swizzle_bytes": 128}


def fwd_route_id(dtype: torch.dtype, d: int) -> str:
    """The forward's route (one of :data:`FWD_ROUTE_IDS`) for q of ``dtype``
    and head width ``d`` (a multiple of 8)."""
    if d > 256:
        return "wide"
    if dtype == torch.bfloat16:
        return "bf16_wgmma" if d > 128 else "bf16"
    return "fp32"


def flash_fwd_plan(dtype: torch.dtype, b: int, n: int, h: int, d: int, kv_len: int | None = None,
                   strides=None) -> dict:
    """The forward kernel's launch plan for q (b, n, h, d) and k, v (b, kv_len,
    h, d), d a multiple of 8: its ``route`` (one of :data:`FWD_ROUTE_IDS`),
    ``grid`` (query tiles of one (batch, head) side by side on grid.x; the
    wide route's head-dim blocks of 128 on grid.y), ``threads``,
    ``smem_bytes`` and, on the wgmma route, the ``tensor_maps`` of q, k and v
    for element ``strides`` ((sb, sn, sh) each, contiguous views if None).
    The same arithmetic as ``ldm3d_flash_fwd_plan`` of the CUDA library
    (the plan its launch reads), which ``chip_smoke.py`` holds it to on the
    card, tensor maps included."""
    kv_len = n if kv_len is None else kv_len
    route = fwd_route_id(dtype, d)
    bm, threads, smem = _FWD_TILES[route]
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    plan = {"route": route, "grid": (-(-n // bm) * b * h, -(-d // 128) if route == "wide" else 1),
            "threads": threads, "smem_bytes": smem.get(dmax, 0)}
    if route == "bf16_wgmma":
        if strides is None:
            strides = [(n * h * d, h * d, d)] + [(kv_len * h * d, h * d, d)] * 2
        plan["tensor_maps"] = {
            name: _tensor_map(rows, h, b, d, st, box)
            for name, rows, st, box in (("q", n, strides[0], bm), ("k", kv_len, strides[1],
                                                                   _WG_KV_ROWS),
                                        ("v", kv_len, strides[2], _WG_KV_ROWS))}
    return plan


# The backward's routes (csrc/flash_bwd.cu), numbered as the route ids of
# ``ldm3d_flash_bwd_plan``: bf16 at 128 < d <= 256 on mma.sync, bf16 up to
# d = 128 on wgmma with TMA, fp32 up to 256 on 3xTF32 mma.sync, and either
# dtype above 256 on the scalar wide kernels.
BWD_ROUTE_IDS = ("bf16", "bf16_wgmma", "fp32", "wide")
_BW_ROWS, _BW_TILE, _BW_STAGES = 128, 64, 4  # the wgmma route: resident, streamed rows; stages


def bwd_route_id(dtype: torch.dtype, d: int) -> str:
    """The backward's route (one of :data:`BWD_ROUTE_IDS`) for q of
    ``dtype`` and head width ``d`` (a multiple of 8), the same for dQ and
    dK/dV."""
    if d > 256:
        return "wide"
    if dtype == torch.bfloat16:
        return "bf16_wgmma" if d <= 128 else "bf16"
    return "fp32"


def _bwd_launch(kind: str, route: str, dmax: int) -> tuple[int, int, int, int]:
    """(rows a block on grid.x, head dims a block on grid.y or 0 for all,
    threads, dynamic shared-memory bytes) of a backward kernel: the
    arithmetic of the tile structs of ``csrc/flash_bwd.cu``."""
    if route == "wide":
        return (64, 128, 256, 0) if kind == "dq" else (32, 64, 256, 0)
    if route == "bf16_wgmma":
        res, tile = dmax * 2 * _BW_ROWS, dmax * 2 * _BW_TILE  # bytes of a resident, streamed tile
        tiles = 2 * res + 2 * _BW_STAGES * tile
        bars = 8 * (1 + 2 * _BW_STAGES)
        vec = 2 * 2 * 2 * _BW_TILE * 4 if kind == "dkv" else 0
        return _BW_ROWS, 0 if kind == "dq" else 64, 256, tiles + vec + bars + 1024
    if route == "bf16":  # DqMma<256>, DkvMma<256>: rows of 264 bf16
        ld = 256 + 8
        if kind == "dq":
            return 128, 0, 256, (2 * 128 + 2 * 2 * 32) * ld * 2
        return 128, 128, 256, 2 * 128 * ld * 2 + 2 * (2 * 32 * ld * 2 + 2 * 32 * 4)
    warps = 4 if dmax > 128 else 8  # fp32: DqTf32, DkvTf32
    if kind == "dq":
        bn, lda, ldb = (16 if dmax > 128 else 32), dmax + 4, dmax + 8
        return (16 * warps, 0, 32 * warps,
                (16 * warps * (lda + ldb) + 2 * bn * (lda + ldb)) * 4)
    bm, slots, ld = (32 if dmax <= 64 else 16), (2 if dmax > 128 else 3), dmax + 4
    return (16 * warps, min(dmax, 128), 32 * warps,
            (2 * 16 * warps * ld + slots * (2 * bm * ld + 2 * bm)) * 4)


def flash_bwd_plan(kind: str, dtype: torch.dtype, b: int, n: int, h: int, d: int,
                   kv_len: int | None = None, strides=None) -> dict:
    """The launch plan of the backward's dQ (``kind="dq"``) or dK/dV
    (``"dkv"``) kernel for q, dO (b, n, h, d) and k, v (b, kv_len, h, d), d a
    multiple of 8: its ``route`` (one of :data:`BWD_ROUTE_IDS`), ``grid``
    (row tiles of the output, dQ's queries or dK/dV's keys, of one (batch,
    head) side by side on grid.x; blocks of head dims on grid.y), ``threads``,
    ``smem_bytes`` and, on the wgmma route, the ``tensor_maps`` of q, k, v and
    dO for element ``strides`` ((sb, sn, sh) each, contiguous if None): dQ's
    q and dO in boxes of 128 rows and k, v of 64, dK/dV's the other way
    round. The same arithmetic as ``ldm3d_flash_bwd_plan`` of the CUDA
    library (the plan its launches read), which ``chip_smoke.py`` holds it
    to on the card, tensor maps included."""
    kv_len = n if kv_len is None else kv_len
    route = bwd_route_id(dtype, d)
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    rows, dout, threads, smem = _bwd_launch(kind, route, dmax)
    out_rows = n if kind == "dq" else kv_len
    plan = {"route": route, "grid": (-(-out_rows // rows) * b * h, -(-d // dout) if dout else 1),
            "threads": threads, "smem_bytes": smem}
    if route == "bf16_wgmma":
        if strides is None:
            strides = [(n * h * d, h * d, d)] + [(kv_len * h * d, h * d, d)] * 2 + [
                (n * h * d, h * d, d)]
        q_box, k_box = (_BW_ROWS, _BW_TILE) if kind == "dq" else (_BW_TILE, _BW_ROWS)
        plan["tensor_maps"] = {
            name: _tensor_map(rows_of, h, b, d, st, box)
            for name, rows_of, st, box in (("q", n, strides[0], q_box),
                                           ("k", kv_len, strides[1], k_box),
                                           ("v", kv_len, strides[2], k_box),
                                           ("dO", n, strides[3], q_box))}
    return plan


def _count_case(fn, q: torch.Tensor, k: torch.Tensor) -> None:
    key = (tuple(q.shape), k.shape[1], str(q.dtype).removeprefix("torch."))
    fn.cases[key] = fn.cases.get(key, 0) + 1


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
    flash_attention_fwd.route_launches[fwd_route_id(q.dtype, d)] += 1
    _count_case(flash_attention_fwd, q, k)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None):
    """Attention forward returning ``(O, LSE)``: the CUDA kernel on CUDA
    tensors, :func:`attention_reference` on CPU tensors. ``scale`` multiplies
    the logits, by default 1/sqrt(head_dim).

    ``flash_attention_fwd.launches`` counts kernel launches (and only those),
    ``flash_attention_fwd.route_launches`` the same launches by route (the
    keys of :data:`FWD_ROUTE_IDS`).
    """
    _check_inputs(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    raise ValueError(f"attention runs on cuda (kernel) or cpu (plain), not {q.device}")


flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = dict.fromkeys(FWD_ROUTE_IDS, 0)
flash_attention_fwd.cases = {}


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
    as the forward's. ``flash_attention_bwd_dq.launches`` counts kernel launches,
    ``flash_attention_bwd_dq.route_launches`` the same launches by route (the
    keys of :data:`BWD_ROUTE_IDS`)."""
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
    flash_attention_bwd_dq.route_launches[bwd_route_id(q.dtype, d)] += 1
    _count_case(flash_attention_bwd_dq, q, k)
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.route_launches = dict.fromkeys(BWD_ROUTE_IDS, 0)
flash_attention_bwd_dq.cases = {}


def flash_attention_bwd_dkv(q, k, v, do, lse, dvec, scale=None):
    """(dK, dV) of attention: the kernel ``ldm3d_flash_bwd_dkv`` of
    ``csrc/flash_bwd.cu`` on CUDA tensors, :func:`attention_bwd_dkv_reference`
    on CPU tensors; ``scale`` as the forward's.
    ``flash_attention_bwd_dkv.launches`` counts kernel launches and
    ``flash_attention_bwd_dkv.route_launches`` the same by route."""
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
    flash_attention_bwd_dkv.route_launches[bwd_route_id(q.dtype, d)] += 1
    _count_case(flash_attention_bwd_dkv, q, k)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.route_launches = dict.fromkeys(BWD_ROUTE_IDS, 0)
flash_attention_bwd_dkv.cases = {}


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
