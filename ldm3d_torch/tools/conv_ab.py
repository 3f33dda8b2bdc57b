"""On-card A/B of the implicit-GEMM conv kernel (B6) at the L0 shapes.

The port's counterpart of ``tools/conv_ab.py``, and the entry point of
:func:`ldm3d_torch.ops.conv3d.conv3d_igemm`. At each shape and dtype it
first holds the kernel against its plain version (fp32 within 1e-5 of the
largest |plain|, the JAX test's limit; bf16 within 2^-7 of it, one bf16 ulp,
since both round the same fp32 sum), then times the kernel, the plain
version and cuDNN (``F.conv3d`` on ``channels_last_3d`` in the same dtype,
TF32 off). It prints one JSON line per (shape, dtype) and a summary line.

Times are device ms per call: back-to-back calls between two CUDA events,
queued behind a spin kernel, the median of several loops; ``host_ms`` is the
host's cost to issue one call. ``bound_ms`` is the larger of the flops over
the card's peak for the dtype and the bytes (x, w and y once) over its
memory rate; ``frac_peak`` is the flops over kernel time over that peak.
Peaks are the NVIDIA H100 SXM data sheet's, at the full 700 W.

    python -m ldm3d_torch.tools.conv_ab                      # every shape, bf16 and fp32
    python -m ldm3d_torch.tools.conv_ab --shape 8,64,64,64,64
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch
import torch.nn.functional as F

from ldm3d_torch.ops.conv3d import conv3d_igemm, conv3d_ref

# the flagship L0 shapes (B, D, H, W, C): the VAE at the 64^3 training crop,
# its decoder's full-resolution level at 96^3 (batch 8 and the batch-2
# serving decode), and the port's 80^3 decoder level 0 at batch 1
SHAPES = ((8, 64, 64, 64, 64), (8, 96, 96, 96, 64), (2, 96, 96, 96, 64), (1, 80, 80, 80, 64))
DTYPES = ("bfloat16", "float32")
# NVIDIA H100 SXM: dense bf16 tensor cores, fp32 on the CUDA cores; HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel against plain, relative to the largest |plain| of the shape
REL_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
SPIN_CYCLES = 20_000_000


def flops_of(shape, cout: int) -> float:
    b, d, h, w, c = shape
    return 2.0 * b * d * h * w * 27 * c * cout


def bound_ms(shape, cout: int, dtype: str) -> tuple[float, str]:
    """Least time (ms) the card could take, and whether operations or bytes bound it."""
    b, d, h, w, c = shape
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = (b * d * h * w * (c + cout) + 27 * c * cout) * itemsize
    t_ops, t_bytes = flops_of(shape, cout) / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, calls: int, reps: int, warmup: int = 1) -> float:
    """Device ms per call: the median over ``reps`` loops of ``calls``
    back-to-back calls between two CUDA events, behind a spin kernel."""
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


def host_ms(fn, calls: int = 3, reps: int = 3) -> float:
    """Host ms to issue one call, without waiting for the card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def run_shape(shape, dtype: str, seed: int = 1) -> dict:
    """Check the kernel against its plain version at ``shape``, then time the
    kernel, the plain version and cuDNN; returns the record."""
    b, d, h, w, c = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    wt = (torch.randn((3, 3, 3, c, c), generator=gen, device="cuda") * c**-0.5).to(dt)

    # a fast wrong kernel is not a result: parity first
    out = conv3d_igemm(x, wt)
    torch.cuda.synchronize()
    ref = conv3d_ref(x, wt)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item() or 1.0
    del out, ref
    if not err <= REL_TOL[dtype] * scale:
        raise AssertionError(f"conv3d_igemm differs from plain by {err} (limit "
                             f"{REL_TOL[dtype] * scale}) at {shape} {dtype}")

    xc = x.permute(0, 4, 1, 2, 3)  # NCDHW logical, channels_last_3d memory
    wc = wt.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    loop = {"calls": 3, "reps": 3} if flops_of(shape, c) > 2e11 else {"calls": 10, "reps": 5}
    rec = {"shape": list(shape), "dtype": dtype,
           "kernel_ms": cuda_ms(lambda: conv3d_igemm(x, wt), **loop),
           "host_ms": host_ms(lambda: conv3d_igemm(x, wt)),
           "plain_ms": cuda_ms(lambda: conv3d_ref(x, wt), **loop),
           "library_ms": cuda_ms(lambda: F.conv3d(xc, wc, padding=1), **loop),
           "max_abs_err": err, "rel_err": err / scale, "rel_tol": REL_TOL[dtype]}
    rec["bound_ms"], rec["bound_by"] = bound_ms(shape, c, dtype)
    peak = PEAK_FLOPS[dtype]
    rec["frac_peak"] = flops_of(shape, c) / (rec["kernel_ms"] * 1e-3) / peak
    rec["library_frac_peak"] = flops_of(shape, c) / (rec["library_ms"] * 1e-3) / peak
    del x, wt, xc, wc
    torch.cuda.empty_cache()
    return rec


def run(shapes=SHAPES, dtypes=DTYPES, emit=lambda rec: None) -> list[dict]:
    """Every (shape, dtype) record; ``emit`` gets each as it comes."""
    if not torch.cuda.is_available():
        raise RuntimeError("conv_ab measures the CUDA kernel and needs a CUDA device")
    # the plain version's fp32 products and cuDNN's fp32 convolution in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = []
    for shape in shapes:
        for dtype in dtypes:
            recs.append(run_shape(tuple(shape), dtype))
            emit(recs[-1])
    return recs


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default=None, help="B,D,H,W,C (default: every L0 shape)")
    args = ap.parse_args(argv)
    shapes = [tuple(int(v) for v in args.shape.split(","))] if args.shape else SHAPES
    recs = run(shapes, emit=lambda rec: print(json.dumps(rec), flush=True))
    wins = sum(r["kernel_ms"] < r["library_ms"] for r in recs)
    print(json.dumps({"summary": f"{wins}/{len(recs)} cases faster than cuDNN",
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return recs


if __name__ == "__main__":
    main()
