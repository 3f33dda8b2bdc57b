"""Container health check CLI with the reference's exit-code contract.

The port of ``ldm3d_tpu/serving/health_check.py``: checks the CUDA device,
the port's model files, disk space, memory and (optionally) the API
endpoint; exit 0 = healthy, 1 = unhealthy. Memory is read from
``/proc/meminfo`` and disk from ``shutil.disk_usage``, with no dependency on
``psutil``.

Usage: python -m ldm3d_torch.serving.health_check [--model-dir D] [--api-url U]
       [--min-disk-gb G] [--max-mem-pct P] [--skip-device]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def check_device() -> dict:
    try:
        import torch

        if not torch.cuda.is_available():
            return {"ok": False, "error": "no CUDA device is available"}
        n = torch.cuda.device_count()
        return {"ok": True, "platform": "cuda", "count": n,
                "names": [torch.cuda.get_device_name(i) for i in range(n)]}
    except Exception as e:
        return {"ok": False, "error": str(e)}


def check_model_files(model_dir: str | None) -> dict:
    """The two checkpoints the server loads (``ldm3d_torch.ckpt.CheckpointManager``)."""
    if not model_dir:
        return {"ok": True, "skipped": True}
    required = [os.path.join(model_dir, "autoencoder_best.pt"),
                os.path.join(model_dir, "diffusion_best.pt")]
    missing = [p for p in required if not os.path.isfile(p)]
    return {"ok": not missing, "missing": missing}


def check_disk(min_free_gb: float) -> dict:
    free_gb = shutil.disk_usage(os.getcwd()).free / 2**30
    return {"ok": free_gb >= min_free_gb, "free_gb": round(free_gb, 1)}


def meminfo_kib(meminfo: str = "/proc/meminfo") -> dict:
    """The fields of ``/proc/meminfo``, in KiB."""
    fields = {}
    with open(meminfo) as f:
        for line in f:
            name, _, rest = line.partition(":")
            fields[name] = int(rest.split()[0])
    return fields


def memory_used_pct(meminfo: str = "/proc/meminfo") -> float:
    """Share of memory in use, ``100 * (1 - MemAvailable / MemTotal)``."""
    fields = meminfo_kib(meminfo)
    return round(100.0 * (1.0 - fields["MemAvailable"] / fields["MemTotal"]), 1)


def check_memory(max_used_pct: float) -> dict:
    try:
        pct = memory_used_pct()
    except (OSError, KeyError, ValueError) as e:
        return {"ok": False, "error": str(e)}
    return {"ok": pct <= max_used_pct, "used_pct": pct}


def check_api(url: str | None) -> dict:
    if not url:
        return {"ok": True, "skipped": True}
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + "/health", timeout=5) as r:
            payload = json.loads(r.read())
        return {"ok": r.status == 200 and payload.get("status") in ("healthy", "degraded"),
                "status": payload.get("status")}
    except Exception as e:
        return {"ok": False, "error": str(e)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="container health check")
    p.add_argument("--model-dir", default=os.environ.get("MODEL_DIR"))
    p.add_argument("--api-url", default=os.environ.get("API_URL"))
    p.add_argument("--min-disk-gb", type=float, default=1.0)
    p.add_argument("--max-mem-pct", type=float, default=95.0)
    p.add_argument("--skip-device", action="store_true")
    args = p.parse_args(argv)

    checks = {
        "device": {"ok": True, "skipped": True} if args.skip_device else check_device(),
        "model_files": check_model_files(args.model_dir),
        "disk": check_disk(args.min_disk_gb),
        "memory": check_memory(args.max_mem_pct),
        "api": check_api(args.api_url),
    }
    healthy = all(c["ok"] for c in checks.values())
    print(json.dumps({"healthy": healthy, "checks": checks}))
    return 0 if healthy else 1


if __name__ == "__main__":
    sys.exit(main())
