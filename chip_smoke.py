#!/usr/bin/env python3
"""Drive the PyTorch port (``ldm3d_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and the port's sources; it exits non-zero, without a
result line, when any of them is missing or any phase fails. Phases, each
printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``ldm3d_torch/csrc`` (nvcc, sm_90a);
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card, at the attention shapes of the flagship model
   (``config_train_32g.json``) at 80^3 and 96^3, in bf16 and fp32, on
   strided views of a fused qkv as the attention block gives them. Times are
   device ms per call (CUDA events around back-to-back calls, median of 5
   loops); ``kernel_host_ms`` is the host's cost to issue one call; ``library_ms`` is one ``scaled_dot_product_attention``
   call, a yardstick the port never calls; ``bound_ms`` is the larger of the
   bytes over 3.35 TB/s and the flops over the peak for the inputs' type
   (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32);
4. main path: conditional DDIM-50 sampling of the full-width
   ``config_train_32g.json`` models (random weights from a seed) through
   ``ldm3d_torch.cli.inference.main`` with ``--amp``, one 80^3 volume; the
   kernel's launch count over that run must be exactly 554 (a warm-up run
   comes first); then one more run under ``torch.profiler`` gives the device
   time by category (by enclosing aten op, else by kernel name) and the
   device's idle share;
5. card against CPU: the ``config_tiny_cpu.json`` sample with the same
   weights, noise and condition on the card (kernel) and on the CPU (plain),
   fp32 with TF32 off, decoded volumes within 1e-3.

The last three lines are the kernels' summary JSON, the ``nvidia-smi`` line,
and ``{"ok": true, "device": {...}}``.
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

# Tolerances of the kernel against its plain version. Both compute in fp32
# from the same inputs, so they differ by summation order only: 1e-4 on the
# fp32 O and on the LSE in both dtypes. A bf16 O is that fp32 result rounded
# once, so an element may differ by one bf16 ulp of itself, at most 2^-7 of
# the largest |O| of the shape: the bf16 limit is 2^-7 * max|O_plain|.
TOL_FP32 = 1e-4
BF16_OUT_REL = 2.0**-7


def out_tol(dtype: str, ref_max: float) -> float:
    return TOL_FP32 if dtype == "float32" else BF16_OUT_REL * ref_max


PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# (B, n, h, d): UNet level 1 and 2 and VAE level 2 at 80^3 (the CLI's patch)
# and at 96^3 (BASELINE.json's size); a batch-2 case; a ragged odd case
MAIN_SHAPES = [(1, 1000, 8, 64), (1, 125, 16, 64), (1, 8000, 1, 256)]
SHAPES = MAIN_SHAPES + [(1, 1728, 8, 64), (1, 216, 16, 64), (1, 13824, 1, 256),
                        (2, 1000, 8, 64), (2, 100, 3, 40)]
# launches of each MAIN_SHAPES entry in one flagship sample (batch 1, DDIM-50):
# 5 UNet level-1 and 6 level-2 attentions per step, 2 in the encoder, 2 in the decoder
LAUNCHES_PER_SAMPLE = {MAIN_SHAPES[0]: 250, MAIN_SHAPES[1]: 300, MAIN_SHAPES[2]: 4}
DDIM_STEPS = 50


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


def bound(shape, dtype: str, itemsize: int) -> tuple[float, str]:
    """Least time (ms) the card could take for one call, and what bounds it."""
    b, n, h, d = shape
    flops = 4.0 * b * h * n * n * d
    nbytes = 4.0 * b * n * h * d * itemsize + 4.0 * b * h * n  # q, k, v, O once; LSE
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_device(torch) -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi_line


def phase_build() -> None:
    from ldm3d_torch.ops import _kernels

    t0 = time.perf_counter()
    lib_path = _kernels.build_library("flash_fwd.cu")
    _kernels.flash_fwd_library()
    log = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": str(lib_path.relative_to(ROOT)), "ptxas": ptxas})


def phase_kernel(torch, F) -> dict:
    """Kernel against plain version at every shape and dtype; returns the
    per-(shape, dtype) measurements."""
    from ldm3d_torch.ops.attention import attention_reference, flash_attention_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape in SHAPES:
            b, n, h, d = shape
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dt)
            q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
            out, lse = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            ref, ref_lse = attention_reference(q, k, v)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            tol = out_tol(dtype, ref.float().abs().max().item())
            check(math.isfinite(err) and err <= tol,
                  f"kernel O differs from plain by {err} (limit {tol}) at {shape} {dtype}")
            check(math.isfinite(lse_err) and lse_err <= TOL_FP32,
                  f"kernel LSE differs from plain by {lse_err} at {shape} {dtype}")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row = {
                "kernel_ms": cuda_ms(torch, lambda: flash_attention_fwd(q, k, v)),
                "kernel_host_ms": host_ms(torch, lambda: flash_attention_fwd(q, k, v)),
                "plain_ms": cuda_ms(torch, lambda: attention_reference(q, k, v)),
                "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                "max_abs_err": err, "lse_max_abs_err": lse_err,
            }
            row["bound_ms"], row["bound_by"] = bound(shape, dtype, qkv.element_size())
            results[(shape, dtype)] = row
            emit({"phase": "kernel", "kernel": "flash_fwd", "shape_bnhd": list(shape),
                  "dtype": dtype, **row, "out_tol": tol, "lse_tol": TOL_FP32})
            del qkv, q, k, v, out, lse, ref, ref_lse
    return results


def _write_env(model_dir: Path) -> Path:
    env = {"model_dir": str(model_dir), "output_dir": str(model_dir / "out"), "seed": 0,
           "synthetic_data": True}
    path = model_dir / "environment.json"
    path.write_text(json.dumps(env))
    return path


def phase_main_path(torch, workdir: Path, card: str, smi_line: str) -> int:
    """Full-width conditional DDIM-50 through the CLI; returns the launch count."""
    from ldm3d_torch.cli.common import save_two_stage
    from ldm3d_torch.cli.inference import main as inference_main
    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.ops.attention import flash_attention_fwd
    from ldm3d_torch.utils.nifti import read_nifti

    t0 = time.perf_counter()
    cfg_path = preset_path("config_train_32g.json")
    ns = SimpleNamespace(**load_json(cfg_path))
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    # the zero-init output conv would hide every layer (attention included)
    # from the sample: give it seeded lecun-normal weights
    w = unet.conv_out.weight
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
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
    flash_attention_fwd.launches = 0
    written = inference_main(argv, timings=timings)
    launches = flash_attention_fwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(len(written) == 1, f"expected one volume, got {written}")
    vol, _ = read_nifti(written[0])
    check(vol.shape == (80, 80, 80), f"volume shape {vol.shape} != (80, 80, 80)")
    check(bool(np.isfinite(vol).all()), "the sampled volume holds non-finite values")
    expected = sum(LAUNCHES_PER_SAMPLE.values())
    check(launches == expected, f"attention kernel launched {launches} times, expected {expected}")
    encode_ms, denoise_ms, decode_ms = (timings[k][0] for k in ("encode_ms", "denoise_ms",
                                                                 "decode_ms"))
    emit({"phase": "main_path", "config": "config_train_32g.json", "volume": list(vol.shape),
          "sampler": f"ddim-{DDIM_STEPS}", "dtype": "bfloat16", "batch": 1,
          "unet_params": n_params[0], "autoencoder_params": n_params[1],
          "setup_s": round(setup_s, 3), "encode_ms": encode_ms,
          "denoise_ms_per_step": denoise_ms / DDIM_STEPS, "decode_ms": decode_ms,
          "volumes_per_s": 1e3 / (denoise_ms + decode_ms),
          "volumes_per_s_with_encode": 1e3 / (encode_ms + denoise_ms + decode_ms),
          "flash_fwd_launches": launches, "peak_device_memory_gib": peak_gib,
          "volume_min": float(vol.min()),
          "volume_max": float(vol.max()), "card": card, "nvidia_smi": smi_line})
    shutil.rmtree(model_dir / "out")
    phase_profile(torch, argv)
    return launches


# A device kernel launched inside one of these aten ops is filed under the
# outermost such op that encloses it, whatever the kernel's name: cuDNN may
# run a 1x1 conv as a GEMM, and a Dense's bias add is part of the Dense.
OP_CATEGORIES = (
    ("convolution", ("aten::conv3d", "aten::convolution")),
    ("matmul (Dense)", ("aten::linear", "aten::addmm", "aten::mm", "aten::matmul")),
    ("dtype casts (weights; GroupNorm fp32 input and coefficients)",
     ("aten::to", "aten::_to_copy")),
)
# Any other kernel (the attention kernel, launched through ctypes outside any
# aten op, among them) by its name; first match wins.
KERNEL_CATEGORIES = (
    ("attention (flash_fwd)", ("flash_fwd_kernel",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "winograd", "implicit")),
    ("matmul (Dense)", ("gemm", "gemv", "nvjet", "cublas", "cutlass", "splitk")),
    ("reduction (GroupNorm statistics)", ("reduce",)),
    ("elementwise (GroupNorm affine, SiLU, adds)", ("elementwise", "vectorized")),
    ("layout and copies (cat, pad, upsample)", ("cat", "copy", "pad", "upsample", "nearest")),
)


def _op_category(ev) -> str | None:
    """Category of the outermost aten op of OP_CATEGORIES enclosing ``ev``."""
    cat = None
    while ev is not None:
        cat = next((c for c, ops in OP_CATEGORIES if ev.name in ops), cat)
        ev = ev.cpu_parent
    return cat


def _is_memory_op(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def phase_profile(torch, argv) -> None:
    """One more CLI run under torch.profiler: device time by kernel category
    over the sample, and the device's idle share of the encode + denoise +
    decode window (the profiler's own overhead is inside that window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ldm3d_torch.cli.inference import main as inference_main

    timings: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        inference_main(argv, timings=timings)
    window_ms = sum(timings[k][0] for k in ("encode_ms", "denoise_ms", "decode_ms"))
    by_cat: dict[str, float] = {}
    names_by_cat: dict[str, dict[str, float]] = {}

    def add(cat: str, name: str, ms: float) -> None:
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        names = names_by_cat.setdefault(cat, {})
        names[name[:200]] = names.get(name[:200], 0.0) + ms

    device_events = [ev for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA and not _is_memory_op(ev.key)]
    device_names = {ev.key for ev in device_events}
    # kernels (checkpoint-load and host copies aside) filed by enclosing op
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
    # the rest of each kernel's device time, filed by the kernel's name
    kernels = []
    for ev in device_events:
        ms = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0)) / 1e3
        kernels.append((ms, ev.count, ev.key[:200]))
        rest = ms - by_op.get(ev.key, 0.0)
        if rest > 1e-6:
            low = ev.key.lower()
            add(next((c for c, pats in KERNEL_CATEGORIES if any(p in low for p in pats)),
                     "other"), ev.key, rest)
    busy = sum(by_cat.values())
    check(busy > 0, "the profiler saw no device kernels")
    emit({"phase": "profile", "window_ms": window_ms, "device_busy_ms": busy,
          "device_idle_share": max(0.0, 1.0 - busy / window_ms),
          "device_ms_filed_by_op": attributed_ms,
          "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
          "top_kernels_by_category": {
              cat: [{"ms": ms, "name": name} for name, ms in
                    sorted(names.items(), key=lambda kv: -kv[1])[:3]]
              for cat, names in names_by_cat.items()},
          "top_kernels": [{"ms": ms, "calls": n, "name": name}
                          for ms, n, name in sorted(kernels, reverse=True)[:12]]})


def phase_card_vs_cpu(torch) -> None:
    """The tiny preset's whole sample on the card (kernel) and on the CPU
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import ldm3d_torch  # noqa: F401  (fails outside a checkout of the repo)

    card, smi_line = phase_device(torch)
    phase_build()
    results = phase_kernel(torch, F)
    workdir_root = ROOT / "build" / "chip_smoke"
    workdir_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir_root) as workdir:
        launches = phase_main_path(torch, Path(workdir), card, smi_line)
    phase_card_vs_cpu(torch)

    def per_sample(key: str, by: str | None = None) -> float:
        return sum(n * results[(shape, "bfloat16")][key]
                   for shape, n in LAUNCHES_PER_SAMPLE.items()
                   if by is None or results[(shape, "bfloat16")]["bound_by"] == by)

    emit({"phase": "done"})
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": "ldm3d_torch/csrc/flash_fwd.cu",
        "replaces": "ldm3d_tpu/ops/attention.py:49 and ldm3d_tpu/ops/attention.py:83",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": per_sample("kernel_ms"), "plain_ms": per_sample("plain_ms"),
        "bound_ms": per_sample("bound_ms"),
        "bound_by": max(("operations", "bytes"), key=lambda by: per_sample("bound_ms", by)),
        "library_ms": per_sample("library_ms"),
        "host_ms": per_sample("kernel_host_ms"),
        "per": "one flagship sample (80^3, batch 1, DDIM-50, bf16): the sum over its "
               "554 launches at the three main-path shapes",
    }]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
