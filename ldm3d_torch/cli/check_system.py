"""System advisor CLI: probe the CUDA card and the host, recommend a
training config.

The port of ``ldm3d_tpu/cli/check_system.py`` (reference
``3d_ldm/check_system.py``: probe -> recommended settings ->
``config_optimized.json`` + launch command, :15,131,195,241):

  * probes the CUDA devices through torch (platform ``gpu``, name, count,
    each card's memory as ``per_chip_hbm_bytes``) and the host from
    ``os.cpu_count``, ``/proc/meminfo`` and ``shutil.disk_usage`` (no
    ``psutil``),
  * recommends a preset and a batch and patch from the card's memory, with
    the JAX package's tiers, and a remat mode from the port's own model of
    the stage-1 step's peak memory (calibrated on an H100, below),
  * writes ``config_optimized.json`` (validated by the port's schema) and
    prints the launch command.

Usage: python -m ldm3d_torch.cli.check_system [--output config_optimized.json] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from ldm3d_torch.configs import load_json, preset_path
from ldm3d_torch.configs.schema import validate_config
from ldm3d_torch.serving.health_check import meminfo_kib

__all__ = ["probe_devices", "probe_host", "estimate_stage1_peak_bytes", "recommend_settings",
           "generate_config_file", "generate_launch_command", "main"]


def probe_devices() -> dict:
    """The CUDA devices as torch sees them, under the JAX probe's keys."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"available": False, "error": "no CUDA device is available"}
        props = torch.cuda.get_device_properties(0)
        return {
            "available": True,
            "platform": "gpu",
            "device_kind": props.name,
            "num_devices": torch.cuda.device_count(),
            "num_hosts": 1,
            "per_chip_hbm_bytes": int(props.total_memory),
        }
    except Exception as e:  # pragma: no cover
        return {"available": False, "error": str(e)}


def probe_host() -> dict:
    mem = meminfo_kib()
    du = shutil.disk_usage(os.getcwd())
    return {
        "cpu_count": os.cpu_count(),
        "ram_gb": round(mem["MemTotal"] / 2**20, 1),
        "ram_available_gb": round(mem["MemAvailable"] / 2**20, 1),
        "disk_free_gb": round(du.free / 2**30, 1),
        "python": sys.version.split()[0],
    }


# ---------------------------------------------------------------------------
# Stage-1 peak-memory model: the device memory a stage-1 trainer takes,
#
# peak(batch, patch, remat) = OUTSIDE + STATE + ACT_PER_VOXEL * batch * voxels * f(remat)
#
# OUTSIDE is what the process holds outside PyTorch's caching allocator (the
# CUDA context, the kernel modules, the libraries' handles); STATE +
# ACT_PER_VOXEL * ... is fitted to the allocator's peak
# (``torch.cuda.max_memory_reserved``: its blocks, fragmentation included)
# over bf16 adversarial stage-1 steps of ``config_train_32g.json`` (the
# VAE, the CLI's discriminator and LPIPS, AdamW for both) on an H100 80GB
# HBM3 at 700 W: chip_smoke.py's data_tools phase measures the points in
# CALIBRATION, prints the fit and fails when the model is more than 5 %
# off any point (PERF.md section 5). f(remat) is the peak's activation
# share under each mode at the largest point over the share unremated.
# Measured allocator peaks: 2,191,523,840 B at batch 1 @64^3,
# 12,780,044,288 at 2 @96^3 and 14,988,345,344 at 8 @64^3 (the fit within
# 0.4 % of each); at 8 @64^3 11,632,902,144 under --remat convs and
# 8,105,492,480 under full; 808,255,488 B outside the allocator.
CALIBRATION = ((1, (64, 64, 64)), (2, (96, 96, 96)), (8, (64, 64, 64)))
_OUTSIDE_ALLOCATOR_BYTES = 808_255_488
_STAGE1_STATE_BYTES = 367_311_941
_STAGE1_ACT_BYTES_PER_VOXEL = 6989.49
_REMAT_ACT_FACTOR = {False: 1.0, "none": 1.0, "convs": 0.7705, True: 0.5292, "full": 0.5292}


def estimate_stage1_peak_bytes(batch: int, patch, remat) -> int:
    voxels = 1
    for p in patch:
        voxels *= p
    return int(_OUTSIDE_ALLOCATOR_BYTES + _STAGE1_STATE_BYTES
               + _STAGE1_ACT_BYTES_PER_VOXEL * batch * voxels * _REMAT_ACT_FACTOR[remat])


# recommend no remat only when the modeled peak leaves at least this share of
# the card free; below it, ``--remat convs`` is the recipe
_MIN_HEADROOM = 0.20


def recommend_settings(dev: dict, host: dict) -> dict:
    """Map the card's memory to a preset tier (the reference's 8/16/32 GB
    tiers, ``check_system.py:131-193``, as the JAX package sets them): every
    recommendation carries its modeled peak and headroom share, and no remat
    is advised only with >= 20% headroom."""
    hbm_bytes = dev.get("per_chip_hbm_bytes") or 16 * 2**30
    hbm_gb = hbm_bytes / 2**30
    n = dev.get("num_devices", 1)
    if not dev.get("available"):
        return {"preset": "config_tiny_cpu.json", "amp": False, "batch_size": 1,
                "patch_size": [32, 32, 32], "notes": ["no CUDA device found; CPU debug preset"]}
    if hbm_gb >= 24:
        preset, batch, patch = "config_train_32g.json", 2, [96, 96, 96]
    elif hbm_gb >= 12:
        preset, batch, patch = "config_train_32g.json", 8, [64, 64, 64]
    else:
        preset, batch, patch = "config_train_stable.json", 1, [48, 48, 48]
    # the fastest recipe that keeps >= 20% headroom
    remat = False
    peak = estimate_stage1_peak_bytes(batch, patch, remat)
    headroom = 1 - peak / hbm_bytes
    if headroom < _MIN_HEADROOM:
        remat = "convs"
        peak = estimate_stage1_peak_bytes(batch, patch, remat)
        headroom = 1 - peak / hbm_bytes
    return {
        "preset": preset,
        "amp": True,  # bf16 autocast over fp32 params
        "batch_size": batch,
        "remat": remat,
        "patch_size": patch,
        "estimated_peak_hbm_gb": round(peak / 2**30, 2),
        "hbm_headroom_frac": round(headroom, 3),
        "headroom_basis": ("modeled: the memory held outside the allocator, and state "
                           "and activation bytes a voxel fitted to "
                           "torch.cuda.max_memory_reserved peaks of bf16 stage-1 steps "
                           "on an H100 80GB HBM3 at 700 W (chip_smoke.py data_tools; "
                           "PERF.md section 5)"),
        "data_axis": n,
        "expected_scaling": (f"-g {n}: {n} data-parallel ranks, one a GPU over NCCL, the "
                             "gradients all-reduced after the backward (not overlapped); "
                             "the scaling is not measured (one card)"),
        "notes": [
            f"{dev['device_kind']} x{n}, ~{hbm_gb:.0f} GB memory/card",
            f"stage 1: batch {batch} @{patch[0]}^3 with "
            f"{'--remat convs' if remat == 'convs' else 'no remat'}: modeled peak "
            f"{peak / 2**30:.1f} GiB of {hbm_gb:.0f} GB ({headroom:.0%} headroom); "
            "no remat is only recommended with >=20% headroom",
            "--amp: bf16 compute with fp32 params; no loss scaler",
            "stage 2: the same batch and patch as stage 1 (config_optimized.json)",
        ],
    }


def generate_config_file(rec: dict, out_path: str) -> None:
    cfg = load_json(preset_path(rec["preset"]))
    cfg["autoencoder_train"]["batch_size"] = rec["batch_size"]
    cfg["autoencoder_train"]["patch_size"] = rec["patch_size"]
    # stage 2 at the same tier: the preset's own diffusion_train (the 32g
    # file's batch 20 @ 80^3) is not what this tool sized the card for
    cfg["diffusion_train"]["batch_size"] = rec["batch_size"]
    cfg["diffusion_train"]["patch_size"] = rec["patch_size"]
    validate_config(cfg, source=out_path)  # never emit a config the CLIs reject
    with open(out_path, "w") as f:
        json.dump(cfg, f, indent=2)


def generate_launch_command(rec: dict) -> str:
    remat = rec.get("remat")
    remat_flag = "" if not remat else (
        " --remat" if remat in (True, "full") else f" --remat {remat}")
    return (
        f"python -m ldm3d_torch.cli.train_autoencoder -c "
        f"{rec.get('output', 'config_optimized.json')} -e environment.json"
        + (" --amp" if rec.get("amp") else "") + remat_flag
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="CUDA system advisor (PyTorch port)")
    parser.add_argument("--output", default="config_optimized.json")
    parser.add_argument("--json", action="store_true", help="machine-readable output only")
    args = parser.parse_args(argv)

    dev = probe_devices()
    host = probe_host()
    rec = recommend_settings(dev, host)
    rec["output"] = args.output
    generate_config_file(rec, args.output)
    report = {"devices": dev, "host": host, "recommendation": rec,
              "launch_command": generate_launch_command(rec)}
    if args.json:
        print(json.dumps(report))
    else:
        print(json.dumps(report, indent=2))
        print(f"\nWrote optimized config to {args.output}")
        print(f"Launch: {report['launch_command']}")
    return report


if __name__ == "__main__":
    main()
