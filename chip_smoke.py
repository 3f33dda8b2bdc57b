#!/usr/bin/env python3
"""Drive the PyTorch port (``ldm3d_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and the port's sources; it exits non-zero, without a
result line, when any of them is missing or any phase fails. Phases, each
printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``ldm3d_torch/csrc`` (one nvcc per
   source, all at once, sm_90a);
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card, at the attention shapes of the flagship model
   (``config_train_32g.json``) at 80^3 and 96^3, in bf16 and fp32, and at
   its training shapes (batch 20) in bf16, on strided views of a fused qkv
   as the attention block gives them;
4. kernel_bwd: the flash-attention backward kernels (dQ, dK/dV) against
   their plain versions, at the training shapes, a ragged case and a d = 256
   case, bf16 and fp32; ``library_ms`` is the backward of
   ``scaled_dot_product_attention`` (its forward + backward less its forward);
5. main path, sampling: conditional DDIM-50 sampling of the full-width
   ``config_train_32g.json`` models (random weights from a seed) through
   ``ldm3d_torch.cli.inference.main`` with ``--amp``, one 80^3 volume; the
   attention kernel's launch count over that run must be exactly 554 and
   the GroupNorm-sums kernel's exactly that of the models' GroupNorms (a
   warm-up run comes first); then one more run under ``torch.profiler``
   gives the device time by category and the device's idle share;
6. main path, training: ``ldm3d_torch.cli.train_diffusion.main`` with
   ``--amp --no-images`` on synthetic 80^3 pairs, batch 20, one epoch of 4
   steps (the first a warm-up) and one validation pass; finite losses, the
   diffusion ``best``/``last`` checkpoints written and reloaded, and the
   exact launch count of each of the five kernels; then one step under
   ``torch.profiler``;
7. kernel_gn: the GroupNorm voxel-sums kernels (forward and backward sums)
   against their plain versions at every input the two main paths gave
   them: the wrappers record each launch's (shape, dtype, strides of x and
   dy), and each recorded input is rebuilt with those strides, checked in
   bf16 and fp32 and timed; the times are summed over each path's launches;
8. main path, serving: ``ModelServer`` on the full-width
   ``config_train_32g.json`` models (random weights from a seed), 80^3,
   fp32, DDIM-50, batch 2, behind the port's stdlib HTTP server on
   127.0.0.1: two concurrent conditional POST /generate merged by the
   micro-batcher into one batch-2 call, the same request alone twice (the
   batched-vs-alone and same-seed differences, each held to a stated limit),
   a dpm-20 override, a NIfTI output, GET /health, /metrics and /model/info;
   every response 200, a real (not dummy) model, finite 80^3 volumes, the
   echoed sampler and spacing, and the exact attention and GroupNorm-sums
   launches the served calls imply;
9. kernel_conv: the implicit-GEMM conv kernel (B6) through its entry point
   ``ldm3d_torch.tools.conv_ab`` at its L0 shapes in bf16 and fp32: held
   against its plain version, timed beside cuDNN; the untargeted shapes raise
   on the card too;
10. card against CPU: the ``config_tiny_cpu.json`` sample (as before) and
   one ``config_tiny_cpu.json`` train step, same weights and draws on the
   card (kernels) and on the CPU (plain), fp32 with TF32 off.

The GroupNorm kernel phase (7) runs after the serving path, and replays the
inputs of all three main paths.

Times are device ms per call (CUDA events around back-to-back calls, median
of 5 loops); ``*_host_ms`` is the host's cost to issue one call;
``bound_ms`` is the larger of the bytes over 3.35 TB/s and the flops over
the peak for the inputs' type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
fp32). The last three lines are the kernels' summary JSON, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances of the kernels against their plain versions. Both compute in
# fp32 from the same inputs, so they differ by summation order only: 1e-4 on
# the fp32 O and on the LSE in both dtypes. A bf16 O is that fp32 result
# rounded once, so an element may differ by one bf16 ulp of itself, at most
# 2^-7 of the largest |O| of the shape: the bf16 limit is 2^-7 * max|O_plain|.
TOL_FP32 = 1e-4
BF16_OUT_REL = 2.0**-7
# Attention gradients: fp32 within 1e-4 of the largest |grad| of each output
# (relative: dQ/dK reach ~10 at n = 8000), bf16 within one bf16 ulp of it.
GRAD_FP32_REL = 1e-4
# GroupNorm sums: fp32 sums of up to 10^7 terms in different orders (chunked
# partials against torch's reduction): within 1e-5 of the sum of the
# absolute terms of each (batch, channel).
GN_REL = 1e-5


def out_tol(dtype: str, ref_max: float) -> float:
    return TOL_FP32 if dtype == "float32" else BF16_OUT_REL * ref_max


def grad_tol(dtype: str, ref_max: float) -> float:
    return (GRAD_FP32_REL if dtype == "float32" else BF16_OUT_REL) * ref_max


PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# (B, n, h, d): UNet level 1 and 2 and VAE level 2 at 80^3 (the CLI's patch)
# and at 96^3 (BASELINE.json's size); a batch-2 case; a ragged odd case
MAIN_SHAPES = [(1, 1000, 8, 64), (1, 125, 16, 64), (1, 8000, 1, 256)]
SHAPES = MAIN_SHAPES + [(1, 1728, 8, 64), (1, 216, 16, 64), (1, 13824, 1, 256),
                        (2, 1000, 8, 64), (2, 125, 16, 64), (2, 8000, 1, 256), (2, 100, 3, 40)]
# launches of each MAIN_SHAPES entry in one flagship sample (batch 1, DDIM-50):
# 5 UNet level-1 and 6 level-2 attentions per step, 2 in the encoder, 2 in the decoder
LAUNCHES_PER_SAMPLE = {MAIN_SHAPES[0]: 250, MAIN_SHAPES[1]: 300, MAIN_SHAPES[2]: 4}
DDIM_STEPS = 50

# Training main path: the config's batch 20 at its 80^3 patch; 90 synthetic
# pairs give 81 training pairs (4 steps of 20, the first a warm-up) and 9
# validation pairs (one padded batch).
TRAIN_BATCH = 20
TRAIN_PAIRS = 90
TRAIN_SHAPES = [(20, 1000, 8, 64), (20, 125, 16, 64), (20, 8000, 1, 256)]
# attention launches per training step at each TRAIN_SHAPES entry: the UNet's
# 5 level-1 and 6 level-2 attentions (forward and backward); the forward
# also runs 2 VAE encodes x 2 encoder attentions
TRAIN_FWD_PER_STEP = {TRAIN_SHAPES[0]: 5, TRAIN_SHAPES[1]: 6, TRAIN_SHAPES[2]: 4}
TRAIN_BWD_PER_STEP = {TRAIN_SHAPES[0]: 5, TRAIN_SHAPES[1]: 6}
BWD_SHAPES = TRAIN_SHAPES[:2] + [(2, 100, 3, 40), (1, 8000, 1, 256)]
# card-vs-CPU train step: loss relative 1e-5; each gradient leaf within 1e-3
# of its largest |g| (fp32 convolutions summed in other orders through the
# whole UNet forward and back); parameters within 2 lr + 1e-6: Adam's first
# update is +-lr sign(g), so an element whose gradient is at rounding level
# may move the other way
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3
TINY_LR = 1e-4

# Serving main path: the flagship models in fp32 (as the JAX server serves),
# 80^3, DDIM-50, batch 2; a dpm-20 override. The served volumes are min-max
# normalised to [0, 1]: the same request batched with another or alone, and
# the same seed served twice, may differ by fp32 summation order through 50
# steps of fp32 convolutions (cuDNN may pick its algorithms per call), held to
# 1e-3 like the tiny sample card vs CPU.
SERVE_STEPS = 50
SERVE_DPM_STEPS = 20
SERVE_BATCH = 2
SERVE_TOL = 1e-3

T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; phase lines carry the seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# GPU clock cycles the card spins before each timed loop (about 10 ms), so
# that the host has issued all of the loop's calls before the first one runs
SPIN_CYCLES = 20_000_000


def cuda_ms(torch, fn, calls: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device ms per call: ``calls`` back-to-back calls between one pair of
    CUDA events, divided by ``calls``; the median of ``reps`` such loops.
    Each loop is queued behind a spin kernel, so at shapes where issuing a
    call (tens of us) takes longer than running it, the loop still times the
    card and not the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Host ms to issue one call (wrapper, allocation, launch), without
    waiting for the card: the median over ``reps`` loops of ``calls``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def loop_size(flops: float) -> dict:
    """Fewer timed calls for the heaviest shapes (tens of ms a call)."""
    return {"calls": 3, "reps": 3, "warmup": 1} if flops > 2e11 else {}


def bound_of(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bound(shape, dtype: str, itemsize: int) -> tuple[float, str]:
    """Flash forward: 4 n kv d flops per head; q, k, v, O once and the LSE."""
    b, n, h, d = shape
    return bound_of(4.0 * b * h * n * n * d,
                    4.0 * b * n * h * d * itemsize + 4.0 * b * h * n, dtype)


def bound_bwd(shape, dtype: str, itemsize: int, kind: str) -> tuple[float, str]:
    """dQ: 6 n kv d flops per head, reads q, k, v, dO, LSE, D, writes dQ;
    dK/dV: 8 n kv d flops, the same reads, writes dK and dV."""
    b, n, h, d = shape
    outs = 1 if kind == "dq" else 2
    return bound_of((6.0 if kind == "dq" else 8.0) * b * h * n * n * d,
                    (4.0 + outs) * b * n * h * d * itemsize + 8.0 * b * h * n, dtype)


def phase_device(torch) -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda,
          "disk_free_gib": shutil.disk_usage(ROOT).free / 2**30})
    return name, smi_line


def phase_build() -> None:
    from ldm3d_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build_libraries(_kernels.SOURCES)
    _kernels.flash_fwd_library()
    _kernels.flash_bwd_library()
    _kernels.groupnorm_library()
    _kernels.conv3d_library()
    ptxas = {}
    for path in paths:
        log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
        ptxas[path.name] = [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": [str(p.relative_to(ROOT)) for p in paths], "ptxas": ptxas})


def _fused_qkv(torch, shape, dt, gen):
    b, n, h, d = shape
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dt)
    return qkv, tuple(t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))


def phase_kernel(torch, F) -> dict:
    """Forward kernel against plain version at every shape and dtype; returns
    the per-(shape, dtype) measurements."""
    from ldm3d_torch.ops.attention import attention_reference, flash_attention_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    cases = ([("bfloat16", s) for s in SHAPES + TRAIN_SHAPES]
             + [("float32", s) for s in SHAPES])
    for dtype, shape in cases:
        dt = getattr(torch, dtype)
        b, n, h, d = shape
        qkv, (q, k, v) = _fused_qkv(torch, shape, dt, gen)
        out, lse = flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref, ref_lse = attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = out_tol(dtype, ref.float().abs().max().item())
        del ref, ref_lse
        check(math.isfinite(err) and err <= tol,
              f"kernel O differs from plain by {err} (limit {tol}) at {shape} {dtype}")
        check(math.isfinite(lse_err) and lse_err <= TOL_FP32,
              f"kernel LSE differs from plain by {lse_err} at {shape} {dtype}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        loop = loop_size(4.0 * b * h * n * n * d)
        row = {
            "kernel_ms": cuda_ms(torch, lambda: flash_attention_fwd(q, k, v), **loop),
            "kernel_host_ms": host_ms(torch, lambda: flash_attention_fwd(q, k, v)),
            "plain_ms": cuda_ms(torch, lambda: attention_reference(q, k, v), **loop),
            "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                  **loop),
            "max_abs_err": err, "lse_max_abs_err": lse_err,
        }
        row["bound_ms"], row["bound_by"] = bound(shape, dtype, qkv.element_size())
        results[(shape, dtype)] = row
        emit({"phase": "kernel", "kernel": "flash_fwd", "shape_bnhd": list(shape),
              "dtype": dtype, **row, "out_tol": tol, "lse_tol": TOL_FP32})
        del qkv, q, k, v, out, lse
    torch.cuda.empty_cache()
    return results


def phase_kernel_bwd(torch, F) -> dict:
    """dQ and dK/dV kernels against their plain versions; returns the
    per-(shape, dtype) measurements."""
    from ldm3d_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape in BWD_SHAPES:
            b, n, h, d = shape
            qkv, (q, k, v) = _fused_qkv(torch, shape, dt, gen)
            do = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dt)
            out, lse = A.flash_attention_fwd(q, k, v)
            dvec = A.attention_bwd_dvec(do, out)
            grads = A.flash_attention_bwd(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            refs = A.attention_bwd_reference(q, k, v, out, lse, do)
            errs, tols = {}, {}
            for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
                errs[name] = (got.float() - want.float()).abs().max().item()
                tols[name] = grad_tol(dtype, want.float().abs().max().item())
                check(math.isfinite(errs[name]) and errs[name] <= tols[name],
                      f"flash_bwd {name} differs from plain by {errs[name]} (limit "
                      f"{tols[name]}) at {shape} {dtype}")
            del grads, refs
            loop = loop_size(8.0 * b * h * n * n * d)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qt, kt, vt)
                torch.autograd.grad(o, (qt, kt, vt), dot)

            def sdpa_fwd():
                with torch.no_grad():
                    F.scaled_dot_product_attention(qt, kt, vt)

            row = {
                "dq_ms": cuda_ms(torch, lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, dvec),
                                 **loop),
                "dkv_ms": cuda_ms(torch, lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                                           dvec), **loop),
                "dq_host_ms": host_ms(torch, lambda: A.flash_attention_bwd_dq(q, k, v, do, lse,
                                                                              dvec)),
                "dkv_host_ms": host_ms(torch, lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                                                dvec)),
                "dq_plain_ms": cuda_ms(torch, lambda: A.attention_bwd_dq_reference(
                    q, k, v, do, lse, dvec), **loop),
                "dkv_plain_ms": cuda_ms(torch, lambda: A.attention_bwd_dkv_reference(
                    q, k, v, do, lse, dvec), **loop),
                "sdpa_bwd_ms": cuda_ms(torch, sdpa_fwd_bwd, **loop) - cuda_ms(torch, sdpa_fwd,
                                                                              **loop),
                "max_abs_err": errs, "tol": tols,
            }
            for kind in ("dq", "dkv"):
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_bwd(
                    shape, dtype, qkv.element_size(), kind)
            results[(shape, dtype)] = row
            emit({"phase": "kernel_bwd", "kernel": "flash_bwd", "shape_bnhd": list(shape),
                  "dtype": dtype, **row})
            del qkv, q, k, v, do, out, lse, dvec, qt, kt, vt
            torch.cuda.empty_cache()
    return results


def _flagship_models(torch, ns, gen):
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn import init_weights_

    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    # the zero-init output conv would hide every layer from the output
    w = unet.conv_out.weight
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
    return ae, unet


def _strided_randn(torch, shape, strides, dt, gen, scale: float = 1.0, shift: float = 0.0):
    """Normal draws (times ``scale``, plus ``shift``) in a tensor of the given
    shape and element strides."""
    t = torch.empty_strided(shape, strides, dtype=dt, device="cuda")
    t.copy_(torch.randn(shape, generator=gen, device="cuda") * scale + shift)
    return t


def _layout_name(torch, shape, strides) -> str:
    t = torch.empty_strided(shape, strides, device="meta")
    if t.is_contiguous(memory_format=torch.channels_last_3d):
        return "channels_last_3d"
    if t.is_contiguous():
        return "contiguous"
    return "strides " + ",".join(str(x) for x in strides)


def _layout_tally(torch, cases: dict, at: int) -> dict:
    """Launches by the layout of the tensor whose strides sit at ``key[at]``."""
    tally: dict[str, int] = {}
    for key, n in cases.items():
        name = _layout_name(torch, key[0], key[at])
        tally[name] = tally.get(name, 0) + n
    return tally


def _gn_check(torch, G, kernel: str, x, dy, mean, inv) -> tuple[float, float]:
    """One GroupNorm-sums kernel against its plain version; returns the
    largest absolute error and the largest error over its limit, and fails
    beyond the limit."""
    dims = tuple(range(2, x.dim()))
    if kernel == "gn_sums":
        got = G.gn_sums(x)
        torch.cuda.synchronize()
        want = G.gn_sums_reference(x)
        xf = x.float()
        terms = (xf, xf * xf)
    else:
        got = G.gn_bwd_sums(dy, x, mean, inv)
        torch.cuda.synchronize()
        want = G.gn_bwd_sums_reference(dy, x, mean, inv)
        shape = mean.shape + (1,) * len(dims)
        dyf = dy.float()
        terms = (dyf, dyf * (x.float() - mean.reshape(shape)) * inv.reshape(shape))
    abs_err, worst = 0.0, 0.0
    for g, w, t in zip(got, want, terms):
        tol = GN_REL * t.abs().sum(dim=dims, dtype=torch.float64)
        diff = (g.double() - w.double()).abs()
        abs_err, worst = max(abs_err, diff.max().item()), max(worst, (diff / tol).max().item())
        check(bool((diff <= tol).all()), f"{kernel} differs from plain beyond {GN_REL} of the "
                                         f"absolute sum at {tuple(x.shape)} strides {x.stride()} "
                                         f"{x.dtype}")
    return abs_err, worst


def phase_kernel_gn(torch, paths: dict) -> dict:
    """GroupNorm sums kernels against their plain versions at every input the
    main paths gave them. ``paths`` maps a path's name to the wrappers'
    ``cases`` from its run: {kernel: {(shape, dtype, x strides[, dy
    strides]): launches}}. Each input is rebuilt with its strides, checked in
    bf16 and fp32 and timed in its own dtype; returns each path's totals over
    its launches and the largest errors."""
    from ldm3d_torch.ops import groupnorm as G

    gen = torch.Generator(device="cuda").manual_seed(4)
    measured: dict = {}
    errs = {"gn_sums": 0.0, "gn_bwd_sums": 0.0}
    for kernel in ("gn_sums", "gn_bwd_sums"):
        for key in sorted({k for p in paths.values() for k in p[kernel]}, key=str):
            shape, dtype, x_strides = key[:3]
            dy_strides = key[3] if kernel == "gn_bwd_sums" else None
            b, c = shape[:2]
            v = math.prod(shape[2:])
            row: dict = {"max_abs_err": {}, "max_err_over_tol": {}}
            for check_dtype in (dtype, *({"bfloat16", "float32"} - {dtype})):
                dt = getattr(torch, check_dtype)
                x = _strided_randn(torch, shape, x_strides, dt, gen, 0.5, 0.3)
                dy = None if dy_strides is None else _strided_randn(torch, shape, dy_strides, dt,
                                                                    gen)
                xf = x.float()
                mean = xf.mean(dim=(2, 3, 4))
                inv = torch.rsqrt(xf.var(dim=(2, 3, 4)) + 1e-6)
                del xf
                err, worst = _gn_check(torch, G, kernel, x, dy, mean, inv)
                row["max_abs_err"][check_dtype] = err
                row["max_err_over_tol"][check_dtype] = worst
                errs[kernel] = max(errs[kernel], err)
                if check_dtype == dtype:
                    isz = x.element_size()
                    if kernel == "gn_sums":
                        run = lambda: G.gn_sums(x)  # noqa: E731
                        plain = lambda: G.gn_sums_reference(x)  # noqa: E731
                        row["var_mean_ms"] = cuda_ms(torch, lambda: torch.var_mean(
                            x, dim=(2, 3, 4)))
                        nbytes = b * v * c * isz + 8.0 * b * c
                    else:
                        run = lambda: G.gn_bwd_sums(dy, x, mean, inv)  # noqa: E731
                        plain = lambda: G.gn_bwd_sums_reference(dy, x, mean, inv)  # noqa: E731
                        nbytes = 2.0 * b * v * c * isz + 16.0 * b * c
                    row.update(ms=cuda_ms(torch, run), host_ms=host_ms(torch, run),
                               plain_ms=cuda_ms(torch, plain),
                               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
                del x, dy, mean, inv
            measured[(kernel, key)] = row
            emit({"phase": "kernel_gn", "kernel": kernel, "shape_bcdhw": list(shape),
                  "dtype_timed": dtype, "x_strides": list(x_strides),
                  "x_layout": _layout_name(torch, shape, x_strides),
                  **({} if dy_strides is None else {
                      "dy_strides": list(dy_strides),
                      "dy_layout": _layout_name(torch, shape, dy_strides)}),
                  "launches": {p: cases[kernel].get(key, 0) for p, cases in paths.items()},
                  **row, "rel_tol": GN_REL, "bound_by": "bytes"})
            torch.cuda.empty_cache()
    totals = {}
    for path, kernels in paths.items():
        for kernel, cases in kernels.items():
            if not cases:
                continue
            rows = [(n, measured[(kernel, key)]) for key, n in cases.items()]
            tot = {k: sum(n * r[k] for n, r in rows)
                   for k in ("ms", "host_ms", "plain_ms", "bound_ms", "var_mean_ms")
                   if k in rows[0][1]}
            tot["launches"] = sum(cases.values())
            totals[(path, kernel)] = tot
            emit({"phase": "kernel_gn_path", "path": path, "kernel": kernel, **tot,
                  "distinct_inputs": len(cases), "x_layouts": _layout_tally(torch, cases, 2),
                  **({"dy_layouts": _layout_tally(torch, cases, 3)}
                     if kernel == "gn_bwd_sums" else {})})
    return {"totals": totals, "max_abs_err": errs}


def _write_env(model_dir: Path, **extra) -> Path:
    env = {"model_dir": str(model_dir), "output_dir": str(model_dir / "out"), "seed": 0,
           "synthetic_data": True, "tfevent_path": str(model_dir / "tb"), **extra}
    path = model_dir / "environment.json"
    path.write_text(json.dumps(env))
    return path


def _module_counts(torch, ns) -> dict:
    """GroupNorms and attention blocks per model part, from models built on
    the meta device."""
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn.blocks import AttentionBlock3D, GroupNorm32

    with torch.device("meta"):
        ae = define_instance(ns, "autoencoder_def")
        unet = define_instance(ns, "diffusion_def")

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    return {part: {"gn": count(mod, GroupNorm32), "attn": count(mod, AttentionBlock3D)}
            for part, mod in (("encoder", ae.encoder), ("decoder", ae.decoder), ("unet", unet))}


def _reset_counts() -> None:
    from ldm3d_torch.ops import attention as A
    from ldm3d_torch.ops import conv3d as C
    from ldm3d_torch.ops import groupnorm as G

    for fn in (A.flash_attention_fwd, A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv,
               G.gn_sums, G.gn_bwd_sums, C.conv3d_igemm):
        fn.launches = 0
    G.gn_sums.cases, G.gn_bwd_sums.cases = {}, {}


def _read_counts() -> dict:
    from ldm3d_torch.ops import attention as A
    from ldm3d_torch.ops import conv3d as C
    from ldm3d_torch.ops import groupnorm as G

    return {"flash_fwd": A.flash_attention_fwd.launches,
            "flash_bwd_dq": A.flash_attention_bwd_dq.launches,
            "flash_bwd_dkv": A.flash_attention_bwd_dkv.launches,
            "gn_sums": G.gn_sums.launches, "gn_bwd_sums": G.gn_bwd_sums.launches,
            "conv3d_igemm": C.conv3d_igemm.launches}


def _read_gn_cases() -> dict:
    """The GroupNorm wrappers' launches by input since the last reset."""
    from ldm3d_torch.ops import groupnorm as G

    return {"gn_sums": dict(G.gn_sums.cases), "gn_bwd_sums": dict(G.gn_bwd_sums.cases)}


def phase_main_path(torch, ns, counts, workdir: Path, card: str, smi_line: str) -> dict:
    """Full-width conditional DDIM-50 through the CLI; returns the launch
    counts and the GroupNorm wrappers' inputs of the timed run."""
    from ldm3d_torch.cli.common import save_two_stage
    from ldm3d_torch.cli.inference import main as inference_main
    from ldm3d_torch.configs import preset_path
    from ldm3d_torch.utils.nifti import read_nifti

    t0 = time.perf_counter()
    cfg_path = preset_path("config_train_32g.json")
    ae, unet = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(1))
    model_dir = workdir / "flagship"
    save_two_stage(str(model_dir), ae, unet, scale_factor=0.8)
    n_params = sum(p.numel() for p in unet.parameters()), sum(p.numel() for p in ae.parameters())
    del ae, unet
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0

    env = _write_env(model_dir)
    argv = ["-c", cfg_path, "-e", str(env), "-n", "1", "--sampler", "ddim",
            "--steps", str(DDIM_STEPS), "--amp"]
    inference_main(argv)  # warm-up run: cuDNN plans, allocator, kernel attributes
    shutil.rmtree(model_dir / "out")

    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    written = inference_main(argv, timings=timings)
    launches, gn_cases = _read_counts(), _read_gn_cases()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(len(written) == 1, f"expected one volume, got {written}")
    vol, _ = read_nifti(written[0])
    check(vol.shape == (80, 80, 80), f"volume shape {vol.shape} != (80, 80, 80)")
    check(bool(np.isfinite(vol).all()), "the sampled volume holds non-finite values")
    expected = sum(LAUNCHES_PER_SAMPLE.values())
    check(launches["flash_fwd"] == expected,
          f"attention kernel launched {launches['flash_fwd']} times, expected {expected}")
    expected_gn = (counts["encoder"]["gn"] + DDIM_STEPS * counts["unet"]["gn"]
                   + counts["decoder"]["gn"])
    check(launches["gn_sums"] == expected_gn,
          f"GroupNorm sums kernel launched {launches['gn_sums']} times, expected {expected_gn}")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == launches["gn_bwd_sums"]
          == launches["conv3d_igemm"] == 0,
          f"a backward or conv kernel ran during sampling: {launches}")
    encode_ms, denoise_ms, decode_ms = (timings[k][0] for k in ("encode_ms", "denoise_ms",
                                                                 "decode_ms"))
    emit({"phase": "main_path", "config": "config_train_32g.json", "volume": list(vol.shape),
          "sampler": f"ddim-{DDIM_STEPS}", "dtype": "bfloat16", "batch": 1,
          "unet_params": n_params[0], "autoencoder_params": n_params[1],
          "setup_s": round(setup_s, 3), "encode_ms": encode_ms,
          "denoise_ms_per_step": denoise_ms / DDIM_STEPS, "decode_ms": decode_ms,
          "volumes_per_s": 1e3 / (denoise_ms + decode_ms),
          "volumes_per_s_with_encode": 1e3 / (encode_ms + denoise_ms + decode_ms),
          "launches": launches, "expected_gn_sums": expected_gn,
          "peak_device_memory_gib": peak_gib, "volume_min": float(vol.min()),
          "volume_max": float(vol.max()), "card": card, "nvidia_smi": smi_line})
    shutil.rmtree(model_dir / "out")
    timings = {}
    prof, _ = _profiled(torch, lambda: inference_main(argv, timings=timings))
    window_ms = sum(timings[k][0] for k in ("encode_ms", "denoise_ms", "decode_ms"))
    emit({"phase": "profile", "path": "sampling", **_profile_summary(torch, prof, window_ms)})
    shutil.rmtree(model_dir)
    return launches, gn_cases


# A device kernel launched inside one of these aten ops is filed under the
# outermost such op that encloses it, whatever the kernel's name: cuDNN may
# run a 1x1 conv as a GEMM, and a Dense's bias add is part of the Dense.
OP_CATEGORIES = (
    ("convolution", ("aten::conv3d", "aten::convolution", "aten::convolution_backward")),
    ("matmul (Dense)", ("aten::linear", "aten::addmm", "aten::mm", "aten::matmul")),
    ("dtype casts (weights; GroupNorm coefficients)", ("aten::to", "aten::_to_copy")),
    ("optimizer (Adam)", ("Optimizer.step#Adam.step",)),
)
# Any other kernel (the port's own kernels, launched through ctypes outside
# any aten op, among them) by its name; first match wins.
KERNEL_CATEGORIES = (
    ("attention forward (flash_fwd)", ("flash_fwd_kernel",)),
    ("attention backward (flash_bwd)", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("GroupNorm sums (groupnorm_sums)", ("partial_sums", "combine(")),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "winograd", "implicit")),
    ("matmul (Dense)", ("gemm", "gemv", "nvjet", "cublas", "cutlass", "splitk")),
    ("reduction", ("reduce",)),
    ("elementwise (GroupNorm affine and backward, SiLU, adds, clip)",
     ("elementwise", "vectorized")),
    ("layout and copies (cat, pad, upsample)", ("cat", "copy", "pad", "upsample", "nearest")),
)


def _op_category(ev) -> str | None:
    """Category of the outermost op of OP_CATEGORIES enclosing ``ev``."""
    cat = None
    while ev is not None:
        cat = next((c for c, ops in OP_CATEGORIES if ev.name in ops), cat)
        ev = ev.cpu_parent
    return cat


def _is_memory_op(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    return prof, out


def _profile_summary(torch, prof, window_ms: float) -> dict:
    """Device time by kernel category over a profiled window and the
    device's idle share of it (the profiler's own overhead is inside)."""
    from torch.autograd import DeviceType

    by_cat: dict[str, float] = {}
    names_by_cat: dict[str, dict[str, float]] = {}

    def add(cat: str, name: str, ms: float) -> None:
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        names = names_by_cat.setdefault(cat, {})
        names[name[:200]] = names.get(name[:200], 0.0) + ms

    # a host range (such as Optimizer.step#Adam.step) is mirrored on the
    # device's track as a span over its kernels: it is not a kernel
    averages = prof.key_averages()
    host_names = {ev.key for ev in averages if ev.device_type == DeviceType.CPU}
    device_events = [ev for ev in averages if ev.device_type == DeviceType.CUDA
                     and not _is_memory_op(ev.key) and ev.key not in host_names]
    device_names = {ev.key for ev in device_events}
    by_op: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        cat = _op_category(ev)
        if cat is None:
            continue
        for kern in ev.kernels:
            if kern.name in device_names:
                add(cat, kern.name, kern.duration / 1e3)
                by_op[kern.name] = by_op.get(kern.name, 0.0) + kern.duration / 1e3
    attributed_ms = sum(by_op.values())
    kernels = []
    for ev in device_events:
        ms = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0)) / 1e3
        kernels.append((ms, ev.count, ev.key[:200]))
        rest = ms - by_op.get(ev.key, 0.0)
        if rest > 1e-6:
            low = ev.key.lower()
            add(next((c for c, pats in KERNEL_CATEGORIES if any(p.lower() in low for p in pats)),
                     "other"), ev.key, rest)
    busy = sum(by_cat.values())
    check(busy > 0, "the profiler saw no device kernels")
    return {"window_ms": window_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / window_ms),
            "device_ms_filed_by_op": attributed_ms,
            "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "top_kernels_by_category": {
                cat: [{"ms": ms, "name": name} for name, ms in
                      sorted(names.items(), key=lambda kv: -kv[1])[:3]]
                for cat, names in names_by_cat.items()},
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in sorted(kernels, reverse=True)[:12]]}


def phase_train(torch, ns, counts, workdir: Path, card: str, smi_line: str) -> dict:
    """Full-width stage-2 training through the CLI; returns its record."""
    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.cli.train_diffusion import main as train_main
    from ldm3d_torch.configs import define_instance, preset_path

    t0 = time.perf_counter()
    cfg_path = preset_path("config_train_32g.json")
    model_dir = workdir / "train"
    ae, unet = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(5))
    CheckpointManager(str(model_dir), "autoencoder").save("best", {"state_dict": ae.state_dict()})
    del ae, unet
    torch.cuda.empty_cache()
    env = _write_env(model_dir, synthetic_num=TRAIN_PAIRS, resume_ckpt=False)
    setup_s = time.perf_counter() - t0

    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t_run = time.perf_counter()
    best_val = train_main(["-c", cfg_path, "-e", str(env), "--amp", "--no-images",
                           "--max-epochs", "1"], timings=timings)
    run_s = time.perf_counter() - t_run
    launches, gn_cases = _read_counts(), _read_gn_cases()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    steps = len(timings["train_step_ms"])
    val_batches = sum(timings["val_batches"])
    check(steps >= 4, f"expected at least 4 train steps, got {steps}")
    losses = timings["diffusion_loss"]
    check(all(math.isfinite(x) for x in losses) and math.isfinite(best_val),
          f"non-finite losses: train {losses}, val {best_val}")
    # exact launches: one scale-factor encode, two encodes and a UNet forward
    # and backward per step, two encodes and a UNet forward per val batch
    encodes = 1 + 2 * steps + 2 * val_batches
    expected = {
        "flash_fwd": encodes * counts["encoder"]["attn"] + (steps + val_batches)
        * counts["unet"]["attn"],
        "flash_bwd_dq": steps * counts["unet"]["attn"],
        "flash_bwd_dkv": steps * counts["unet"]["attn"],
        "gn_sums": encodes * counts["encoder"]["gn"] + (steps + val_batches) * counts["unet"]["gn"],
        "gn_bwd_sums": steps * counts["unet"]["gn"],
        "conv3d_igemm": 0,
    }
    for name, n in expected.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times in training, "
                                   f"expected {n}")
    per_step = {
        "flash_fwd": 2 * counts["encoder"]["attn"] + counts["unet"]["attn"],
        "flash_bwd_dq": counts["unet"]["attn"], "flash_bwd_dkv": counts["unet"]["attn"],
        "gn_sums": 2 * counts["encoder"]["gn"] + counts["unet"]["gn"],
        "gn_bwd_sums": counts["unet"]["gn"],
    }

    # the checkpoints exist and reload: best = last's params, last's step
    ckpt = CheckpointManager(str(model_dir), "diffusion")
    check(ckpt.exists("best") and ckpt.exists("last"), "diffusion best/last not written")
    best = ckpt.load("best", map_location="cpu")
    last = ckpt.load("last", map_location="cpu")
    with torch.device("meta"):
        reloaded = define_instance(ns, "diffusion_def")
    reloaded.load_state_dict(best["state_dict"], assign=True)
    check(last["step"] == steps, f"last checkpoint at step {last['step']}, ran {steps}")
    check(all(torch.equal(best["state_dict"][k], v) for k, v in last["params"].items()),
          "best and last params differ after one validated epoch")
    check(all(bool(torch.isfinite(p).all()) for p in reloaded.parameters()),
          "reloaded diffusion params hold non-finite values")
    check(abs(best["meta"]["scale_factor"] - timings["scale_factor"]) == 0,
          "best checkpoint's scale_factor differs from the run's")
    del best, last, reloaded

    step_ms = timings["train_step_ms"][1:]
    median_ms = statistics.median(step_ms)
    record = {"steps": steps, "val_batches": val_batches, "launches": launches,
              "expected_launches": expected, "launches_per_step": per_step,
              "train_step_ms": timings["train_step_ms"], "median_step_ms_after_warmup": median_ms,
              "volumes_per_s_trained": TRAIN_BATCH * 1e3 / median_ms,
              "val_ms": timings["val_ms"], "diffusion_loss": losses, "best_val_loss": best_val,
              "scale_factor": timings["scale_factor"], "peak_device_memory_gib": peak_gib}
    emit({"phase": "train_main_path", "config": "config_train_32g.json",
          "patch": [80, 80, 80], "batch": TRAIN_BATCH, "dtype": "bfloat16",
          "setup_s": round(setup_s, 3), "run_s": round(run_s, 3), **record,
          "card": card, "nvidia_smi": smi_line})
    phase_train_profile(torch, ns, model_dir, timings["scale_factor"])
    shutil.rmtree(model_dir)
    return {**record, "gn_cases": gn_cases}


def phase_train_profile(torch, ns, model_dir: Path, scale_factor: float) -> None:
    """One flagship train step (batch 20, bf16) under torch.profiler, after a
    warm-up step, built from the library's pieces and the run's VAE."""
    from ldm3d_torch.cli.train_diffusion import load_frozen_autoencoder
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage2Config, TrainState, make_diffusion_optimizer,
                                      make_stage2_train_step)

    args = SimpleNamespace(**vars(ns), model_dir=str(model_dir))
    ae = load_frozen_autoencoder(args, torch.device("cuda"), torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.device("cuda"):
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    unet.compute_dtype = torch.bfloat16
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda count: 1e-5))
    step = make_stage2_train_step(unet, ae, DDPMScheduler.create(), Stage2Config())
    batch = {k: torch.rand((TRAIN_BATCH, 80, 80, 80, 1), generator=gen, device="cuda")
             for k in ("image", "label")}
    step(state, batch, scale_factor, gen)
    torch.cuda.synchronize()

    def one_step():
        t0 = time.perf_counter()
        step(state, batch, scale_factor, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prof, window_ms = _profiled(torch, one_step)
    emit({"phase": "profile", "path": "training step (batch 20, 80^3, bf16)",
          **_profile_summary(torch, prof, window_ms)})
    del state, unet, ae, batch
    torch.cuda.empty_cache()

def _post(port: int, body: dict) -> tuple[int, dict, float]:
    """POST /generate on the local server; (status, JSON reply, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data), time.perf_counter() - t0


def _get(port: int, path: str) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _served_volume(reply: dict, tmp: Path) -> np.ndarray:
    """The reply's one volume, decoded from raw float32 or NIfTI."""
    import base64

    from ldm3d_torch.utils.nifti import read_nifti

    sample = reply["samples"][0]
    raw = base64.b64decode(sample["data"])
    if sample["format"] == "nii":
        path = tmp / "served.nii"
        path.write_bytes(raw)
        return read_nifti(str(path))[0]
    return np.frombuffer(raw, np.float32).reshape(sample["shape"])


def phase_serve(torch, ns, counts, workdir: Path, card: str, smi_line: str) -> dict:
    """The serving main path over HTTP; returns its launch counts and the
    GroupNorm wrappers' inputs."""
    import base64
    import threading

    from ldm3d_torch.cli.common import save_two_stage
    from ldm3d_torch.configs import preset_path
    from ldm3d_torch.serving.api_server import Api, make_stdlib_server
    from ldm3d_torch.serving.model_server import ModelServer

    model_dir = workdir / "serve"
    ae, unet = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(8))
    save_two_stage(str(model_dir), ae, unet, scale_factor=0.8)
    del ae, unet
    torch.cuda.empty_cache()
    env = _write_env(model_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ModelServer(preset_path("config_train_32g.json"), str(env), sampler="ddim",
                         steps=SERVE_STEPS, batch=SERVE_BATCH, decode_chunk=0, device="cuda")
    server.load_model()
    load_s = time.perf_counter() - t0
    check(server.is_dummy is False and server.model_loaded, "the server loaded the dummy model")
    # widen the micro-batch window from 10 ms to 1.5 s, so that the merge of
    # the concurrent pair does not hang on the second request's condition
    # encode and HTTP parsing (each alone request then waits out the window)
    server._batcher.max_wait = 1.5
    httpd = make_stdlib_server(Api(server), "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    patch = list(server.patch_size)

    def cond(seed):
        vol = np.random.default_rng(seed).random(patch, dtype=np.float32)
        return {"data": base64.b64encode(vol.tobytes()).decode("ascii"), "shape": patch}

    cond_a, cond_b = cond(1), cond(2)
    try:
        code, _, warm_s = _post(port, {"num_samples": 1, "seed": 0, "condition": cond_a})
        check(code == 200, f"warm-up request returned {code}")
        _reset_counts()
        batches_before = server._batcher.batches_run
        replies, seconds = {}, {}

        def client(name, body):
            code, reply, sec = _post(port, body)
            replies[name], seconds[name] = (code, reply), sec

        pair = [threading.Thread(target=client, args=(name, {"num_samples": 1, "seed": seed,
                                                             "condition": c}))
                for name, seed, c in (("a_batched", 11, cond_a), ("b_batched", 22, cond_b))]
        for t in pair:
            t.start()
        for t in pair:
            t.join()
        merged_calls = server._batcher.batches_run - batches_before
        for name, body in (
                ("a_alone", {"num_samples": 1, "seed": 11, "condition": cond_a}),
                ("a_alone_repeat", {"num_samples": 1, "seed": 11, "condition": cond_a}),
                ("dpm", {"num_samples": 1, "seed": 5, "condition": cond_a, "sampler": "dpm",
                         "inference_steps": SERVE_DPM_STEPS}),
                ("nii", {"num_samples": 1, "seed": 7, "condition": cond_a,
                         "output_format": "nii"})):
            client(name, body)
        torch.cuda.synchronize()
        launches, gn_cases = _read_counts(), _read_gn_cases()
        health = _get(port, "/health")
        metrics = _get(port, "/metrics")
        info = _get(port, "/model/info")
    finally:
        httpd.shutdown()
        httpd.server_close()
        if server._batcher is not None:
            server._batcher.close()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    vols = {}
    for name, (code, reply) in replies.items():
        check(code == 200, f"serve request {name} returned {code}: {reply}")
        want = ("dpm", SERVE_DPM_STEPS) if name == "dpm" else ("ddim", SERVE_STEPS)
        check((reply["sampler"], reply["inference_steps"]) == want,
              f"{name}: served {reply['sampler']}-{reply['inference_steps']}, expected {want}")
        check(reply["timestep_spacing"] == "leading" and reply["conditioning"] == "provided",
              f"{name}: spacing {reply['timestep_spacing']}, conditioning "
              f"{reply['conditioning']}")
        vols[name] = _served_volume(reply, workdir)
        check(vols[name].shape == (80, 80, 80) and bool(np.isfinite(vols[name]).all()),
              f"{name}: volume {vols[name].shape}, finite {np.isfinite(vols[name]).all()}")
    check(merged_calls == 1, f"the two concurrent requests took {merged_calls} sampler calls, "
                             f"not one merged batch-{SERVE_BATCH} call")
    batched_vs_alone = float(np.abs(vols["a_batched"] - vols["a_alone"]).max())
    same_seed = float(np.abs(vols["a_alone"] - vols["a_alone_repeat"]).max())
    check(batched_vs_alone <= SERVE_TOL, f"batched and alone differ by {batched_vs_alone}")
    check(same_seed <= SERVE_TOL, f"a same-seed repeat differs by {same_seed}")
    check(float(np.abs(vols["a_batched"] - vols["b_batched"]).max()) > 0.01,
          "two seeds served the same volume")
    check(health[0] == 200 and json.loads(health[1])["dummy_model"] is False,
          f"/health: {health}")
    check(metrics[0] == 200 and b'api_requests_total{method="POST",endpoint="/generate",'
                                b'status="200"}' in metrics[1], "/metrics lacks the requests")
    check(info[0] == 200 and json.loads(info[1])["backend"] == "cuda", f"/model/info: {info}")

    # launches: every request encodes its condition; four ddim-50 calls (the
    # merged pair, alone twice, the NIfTI one) and one dpm-20 call, each
    # followed by one batch-2 decode
    encodes, decodes = 6, 5
    unet_calls = 4 * SERVE_STEPS + SERVE_DPM_STEPS
    expected = {key: encodes * counts["encoder"][k] + unet_calls * counts["unet"][k]
                + decodes * counts["decoder"][k]
                for key, k in (("flash_fwd", "attn"), ("gn_sums", "gn"))}
    for name, n in expected.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times serving, expected {n}")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == launches["gn_bwd_sums"]
          == launches["conv3d_igemm"] == 0, f"an unexpected kernel ran serving: {launches}")
    emit({"phase": "serve", "config": "config_train_32g.json", "volume": [80, 80, 80],
          "dtype": "float32", "batch": SERVE_BATCH, "sampler": f"ddim-{SERVE_STEPS}",
          "load_s": load_s, "warmup_request_s": warm_s, "request_s": seconds,
          "merged_sampler_calls": merged_calls, "launches": launches,
          "expected_launches": expected, "batched_vs_alone_max_abs": batched_vs_alone,
          "same_seed_max_abs": same_seed, "tol": SERVE_TOL,
          "peak_device_memory_gib": peak_gib, "card": card, "nvidia_smi": smi_line})
    del server
    torch.cuda.empty_cache()
    shutil.rmtree(model_dir)
    return {"launches": launches, "gn_cases": gn_cases}


def phase_kernel_conv(torch) -> dict:
    """B6 through its entry point, the A/B tool, at its shapes in bf16 and
    fp32; returns the records and the tool run's launches."""
    from ldm3d_torch.ops.conv3d import conv3d_igemm
    from ldm3d_torch.tools import conv_ab

    for x_shape, w_shape, msg in (((1, 2, 4, 8, 8), (5, 5, 5, 8, 8), "3x3x3"),
                                  ((1, 2, 4, 8, 128), (3, 3, 3, 128, 128), "C <= 64"),
                                  ((1, 2, 4, 12, 8), (3, 3, 3, 8, 8), "W % 8")):
        try:
            conv3d_igemm(torch.zeros(x_shape, device="cuda"), torch.zeros(w_shape, device="cuda"))
        except ValueError as e:
            check(msg in str(e), f"conv3d_igemm raised {e!r} for {x_shape}, {w_shape}")
        else:
            check(False, f"conv3d_igemm took the untargeted shape {x_shape}, {w_shape}")
    _reset_counts()
    t0 = time.perf_counter()
    recs = conv_ab.run(emit=lambda rec: emit({"phase": "kernel_conv", **rec}))
    launches = _read_counts()
    check(launches["conv3d_igemm"] > 0, "the conv path launched no conv kernel")
    emit({"phase": "kernel_conv_path", "launches": launches["conv3d_igemm"],
          "seconds": time.perf_counter() - t0, "cases": len(recs)})
    return {"records": recs, "launches": launches["conv3d_igemm"]}


def phase_card_vs_cpu(torch) -> None:
    """The tiny preset's whole sample on the card (kernels) and on the CPU
    (plain), same weights, noise and condition, fp32 with TF32 off."""
    import copy

    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.diffusion import DDIMScheduler, inferer
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.ops.attention import flash_attention_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_json(preset_path("config_tiny_cpu.json"))
    ns = SimpleNamespace(**cfg)
    gen = torch.Generator().manual_seed(2)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval()
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen).eval()
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    batch, patch = 2, cfg["diffusion_train"]["patch_size"]
    latent = (batch, *[p // ae.downsample_factor for p in patch], cfg["latent_channels"])
    images = torch.rand((batch, *patch, 1), generator=gen)
    eps, noise = torch.randn(latent, generator=gen), torch.randn(latent, generator=gen)
    sched = DDIMScheduler.create(num_train_timesteps=16, beta_start=0.0015, beta_end=0.0195,
                                 num_inference_steps=8)
    for guidance in (1.0, 2.0):
        outs = {}
        for device in ("cuda", "cpu"):
            a = copy.deepcopy(ae).to(device)
            u = copy.deepcopy(unet).to(device)
            before = flash_attention_fwd.launches
            with torch.no_grad():
                cond = a.encode_stage_2_inputs(images.to(device), eps.to(device))
                vol = inferer.sample(u, a.decode_stage_2_outputs, sched, noise.to(device),
                                     condition=cond, scale_factor=0.8, guidance_scale=guidance)
            outs[device] = (vol.cpu(), flash_attention_fwd.launches - before)
        diff = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
        check(outs["cuda"][1] > 0 and outs["cpu"][1] == 0,
              f"kernel launches card/cpu = {outs['cuda'][1]}/{outs['cpu'][1]}")
        check(math.isfinite(diff) and diff <= 1e-3, f"card and CPU samples differ by {diff}")
        emit({"phase": "card_vs_cpu", "config": "config_tiny_cpu.json", "batch": batch,
              "guidance": guidance, "steps": 8, "max_abs_diff": diff, "tol": 1e-3,
              "card_kernel_launches": outs["cuda"][1]})


def phase_train_card_vs_cpu(torch) -> None:
    """One ``config_tiny_cpu.json`` train step (full step, VAE encode inside)
    on the card (kernels) and on the CPU (plain): same weights, batch and
    draws, fp32 with TF32 off; loss, per-leaf gradients and updated
    parameters compared."""
    import copy

    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage2Config, Stage2Draws, TrainState,
                                      make_diffusion_optimizer, make_stage2_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_json(preset_path("config_tiny_cpu.json"))
    ns = SimpleNamespace(**cfg)
    gen = torch.Generator().manual_seed(7)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval().requires_grad_(False)
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    b, patch = 2, cfg["diffusion_train"]["patch_size"]
    latent = (b, *[p // ae.downsample_factor for p in patch], cfg["latent_channels"])
    batch = {k: torch.rand((b, *patch, 1), generator=gen) for k in ("image", "label")}
    draws = Stage2Draws(torch.randn(latent, generator=gen), torch.randn(latent, generator=gen),
                        torch.randn(latent, generator=gen), torch.tensor([3, 12]),
                        torch.tensor([True, False]))
    s2cfg = Stage2Config(cond_dropout=0.5)
    sched = DDPMScheduler.create(num_train_timesteps=16)
    out = {}
    for device in ("cuda", "cpu"):
        _reset_counts()
        u = copy.deepcopy(unet).to(device)
        a = copy.deepcopy(ae).to(device)
        state = TrainState(u, make_diffusion_optimizer(u.parameters(), lambda count: TINY_LR))
        step = make_stage2_train_step(u, a, sched, s2cfg)
        m = step(state, {k: v.to(device) for k, v in batch.items()}, 0.9, draws=draws.to(device))
        out[device] = {"loss": float(m["diffusion_loss"]), "grad_norm": float(m["grad_norm"]),
                       "grads": {n: p.grad.cpu() for n, p in u.named_parameters()},
                       "params": {n: p.detach().cpu() for n, p in u.named_parameters()},
                       "launches": _read_counts()}
    card, cpu = out["cuda"], out["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_worst = max((card["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                     for n, g in cpu["grads"].items())
    param_worst = max((card["params"][n] - p).abs().max().item()
                      for n, p in cpu["params"].items())
    check(loss_rel <= TRAIN_LOSS_REL, f"card and CPU train-step losses differ by {loss_rel} rel")
    check(grad_worst <= TRAIN_GRAD_REL, f"card and CPU gradients differ by {grad_worst} of "
                                        f"a leaf's largest |g|")
    check(param_worst <= 2 * TINY_LR + 1e-6, f"card and CPU updated params differ by "
                                              f"{param_worst}")
    norm_rel = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    check(norm_rel <= TRAIN_GRAD_REL, f"card and CPU gradient norms differ by {norm_rel} rel")
    launched = card["launches"]
    check(all(launched[k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gn_sums",
                                         "gn_bwd_sums")),
          f"a kernel did not run in the card's train step: {launched}")
    check(all(cpu["launches"][k] == 0 for k in ("flash_fwd", "gn_sums")),
          "the CPU step launched a kernel")
    emit({"phase": "train_card_vs_cpu", "config": "config_tiny_cpu.json", "batch": b,
          "loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel_diff": loss_rel,
          "grad_norm_card": card["grad_norm"], "grad_norm_cpu": cpu["grad_norm"],
          "grad_worst_rel_to_leaf_max": grad_worst, "param_max_abs_diff": param_worst,
          "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel": TRAIN_GRAD_REL,
                  "param_abs": 2 * TINY_LR + 1e-6},
          "card_launches": launched})


def _kernel_summary(fwd: dict, bwd: dict, gn: dict, sample_launches: dict,
                    train: dict, serve: dict, conv: dict) -> list:
    """The kernels line: each kernel's ms, plain_ms, bound_ms and library_ms
    are summed over the ``launches`` it counts (one flagship sample for
    flash_fwd, the training main path's run for the other four; the
    GroupNorm kernels also over the sample, as ``sample_*``); the served
    launches of flash_fwd and gn_sums are ``serve_launches``. conv3d_igemm's
    launches are the A/B tool's run; its times are per call at the tool's
    headline shape."""
    def per(results, weights, key, by=None, dtype="bfloat16"):
        return sum(n * results[(shape, dtype)][key] for shape, n in weights.items()
                   if by is None or results[(shape, dtype)].get("bound_by", by) == by)

    steps = train["steps"]

    def per_bwd(key, by_key=None, by=None):
        """Summed over one training step's launches."""
        return sum(n * bwd[(shape, "bfloat16")][key] for shape, n in TRAIN_BWD_PER_STEP.items()
                   if by is None or bwd[(shape, "bfloat16")][by_key] == by)

    def larger(fn):
        return max(("operations", "bytes"), key=fn)

    run_note = (f"the training main path's run ({steps} steps of batch 20 at 80^3, "
                f"{train['val_batches']} validation batch, the scale-factor encode; bf16): the "
                "sum over its launches")
    bwd_err = {kind: max(max(r["max_abs_err"][k] for k in keys) for r in bwd.values())
               for kind, keys in (("dq", ("dq",)), ("dkv", ("dk", "dv")))}
    sdpa = per_bwd("sdpa_bwd_ms")

    def flash_bwd(name, kind, replaces, library_covers):
        check(train["launches"][name] == steps * sum(TRAIN_BWD_PER_STEP.values()),
              f"{name} launches {train['launches'][name]} are not {steps} steps' worth")
        return {"name": name, "route": "cuda", "source": "ldm3d_torch/csrc/flash_bwd.cu",
                "replaces": replaces, "launches": train["launches"][name],
                "max_abs_err": bwd_err[kind], "ms": steps * per_bwd(f"{kind}_ms"),
                "plain_ms": steps * per_bwd(f"{kind}_plain_ms"),
                "bound_ms": steps * per_bwd(f"{kind}_bound_ms"),
                "bound_by": larger(lambda by: per_bwd(f"{kind}_bound_ms", f"{kind}_bound_by", by)),
                "library_ms": steps * sdpa, "library_covers": library_covers,
                "host_ms": steps * per_bwd(f"{kind}_host_ms"), "per": run_note,
                "ms_per_step": per_bwd(f"{kind}_ms")}

    def gn_row(name, replaces, library_note):
        tr = gn["totals"][("training", name)]
        check(tr["launches"] == train["launches"][name],
              f"{name}: recorded inputs cover {tr['launches']} of {train['launches'][name]} "
              f"training launches")
        row = {"name": name, "route": "cuda", "source": "ldm3d_torch/csrc/groupnorm_sums.cu",
               "replaces": replaces, "launches": tr["launches"],
               "max_abs_err": gn["max_abs_err"][name], "ms": tr["ms"], "plain_ms": tr["plain_ms"],
               "bound_ms": tr["bound_ms"], "bound_by": "bytes", "library_ms": None,
               "library_note": library_note, "host_ms": tr["host_ms"], "per": run_note}
        if "var_mean_ms" in tr:
            row["var_mean_ms"] = tr["var_mean_ms"]
        sa = gn["totals"].get(("sampling", name))
        if sa is not None:
            check(sa["launches"] == sample_launches[name],
                  f"{name}: recorded inputs cover {sa['launches']} of {sample_launches[name]} "
                  f"sampling launches")
            row.update(sample_launches=sa["launches"], sample_ms=sa["ms"],
                       sample_plain_ms=sa["plain_ms"], sample_bound_ms=sa["bound_ms"],
                       sample_host_ms=sa["host_ms"], sample_var_mean_ms=sa["var_mean_ms"])
        return row

    head = next(r for r in conv["records"]
                if tuple(r["shape"]) == (8, 96, 96, 96, 64) and r["dtype"] == "bfloat16")
    conv_row = {"name": "conv3d_igemm", "route": "cuda",
                "source": "ldm3d_torch/csrc/conv3d_igemm.cu",
                "replaces": "ldm3d_tpu/ops/conv3d.py:58", "launches": conv["launches"],
                "max_abs_err": max(r["max_abs_err"] for r in conv["records"]),
                "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "host_ms": head["host_ms"],
                "library_covers": "F.conv3d (cuDNN) on channels_last_3d, bf16",
                "per": "one call at (8, 96, 96, 96, 64) bf16; launches: the A/B tool's whole "
                       "run (checks and timing loops at every shape and dtype)"}
    rows = [
        {"name": "flash_fwd", "route": "cuda", "source": "ldm3d_torch/csrc/flash_fwd.cu",
         "replaces": "ldm3d_tpu/ops/attention.py:49 and ldm3d_tpu/ops/attention.py:83",
         "launches": sample_launches["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in fwd.values()),
         "ms": per(fwd, LAUNCHES_PER_SAMPLE, "kernel_ms"),
         "plain_ms": per(fwd, LAUNCHES_PER_SAMPLE, "plain_ms"),
         "bound_ms": per(fwd, LAUNCHES_PER_SAMPLE, "bound_ms"),
         "bound_by": larger(lambda by: per(fwd, LAUNCHES_PER_SAMPLE, "bound_ms", by)),
         "library_ms": per(fwd, LAUNCHES_PER_SAMPLE, "library_ms"),
         "host_ms": per(fwd, LAUNCHES_PER_SAMPLE, "kernel_host_ms"),
         "per": "one flagship sample (80^3, batch 1, DDIM-50, bf16): the sum over its "
                "554 launches at the three main-path shapes",
         "train_launches": train["launches"]["flash_fwd"],
         "train_step_ms": per(fwd, TRAIN_FWD_PER_STEP, "kernel_ms"),
         "train_step_plain_ms": per(fwd, TRAIN_FWD_PER_STEP, "plain_ms"),
         "train_step_bound_ms": per(fwd, TRAIN_FWD_PER_STEP, "bound_ms"),
         "train_step_library_ms": per(fwd, TRAIN_FWD_PER_STEP, "library_ms")},
        flash_bwd("flash_bwd_dq", "dq", "ldm3d_tpu/ops/attention.py:122",
                  "dQ, dK and dV together: the backward of scaled_dot_product_attention (its "
                  "forward + backward less its forward)"),
        flash_bwd("flash_bwd_dkv", "dkv", "ldm3d_tpu/ops/attention.py:150",
                  "dQ, dK and dV together (as flash_bwd_dq's)"),
        gn_row("gn_sums", "ldm3d_tpu/ops/groupnorm.py:70",
               "no single PyTorch call returns the fp32 per-(batch, channel) sum and sum of "
               "squares; torch.var_mean (Welford mean and variance) is timed beside it as "
               "var_mean_ms"),
        gn_row("gn_bwd_sums", "ldm3d_tpu/ops/groupnorm.py:144",
               "no single PyTorch call returns sum(dy) and sum(dy * x_hat)"),
        conv_row,
    ]
    rows[0]["serve_launches"] = serve["launches"]["flash_fwd"]
    rows[3]["serve_launches"] = serve["launches"]["gn_sums"]
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import ldm3d_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ldm3d_torch.configs import load_json, preset_path

    ns = SimpleNamespace(**load_json(preset_path("config_train_32g.json")))
    counts = _module_counts(torch, ns)
    card, smi_line = phase_device(torch)
    phase_build()
    fwd = phase_kernel(torch, F)
    bwd = phase_kernel_bwd(torch, F)
    workdir_root = ROOT / "build" / "chip_smoke"
    workdir_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir_root) as workdir:
        sample_launches, sample_gn = phase_main_path(torch, ns, counts, Path(workdir), card,
                                                     smi_line)
        train = phase_train(torch, ns, counts, Path(workdir), card, smi_line)
        serve = phase_serve(torch, ns, counts, Path(workdir), card, smi_line)
    gn = phase_kernel_gn(torch, {"sampling": sample_gn, "training": train.pop("gn_cases"),
                                 "serving": serve.pop("gn_cases")})
    conv = phase_kernel_conv(torch)
    phase_card_vs_cpu(torch)
    phase_train_card_vs_cpu(torch)

    emit({"phase": "done"})
    emit({"kernels": _kernel_summary(fwd, bwd, gn, sample_launches, train, serve, conv)})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
