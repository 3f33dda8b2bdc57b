"""On-card sweep of the GroupNorm backward sums' voxel chunks (B5).

At each input (both operands ``channels_last_3d``, as every main path gives
them) it times ``ldm3d_gn_bwd_sums`` under :func:`gn_bwd_sums_plan`'s own
plan and under plans that differ from it only in the number of voxel chunks
(and, at 2 to 8 chunks, with and without a thread-block cluster), after
holding each against the plain version (within 1e-5 of the sum of the
absolute terms, the limit of ``chip_smoke.py``). It prints one JSON line per
(shape, dtype): the plan's chunks, the bound and the device ms of each
candidate, keyed ``"<chunks>"`` or ``"<chunks>c"`` (a cluster), and ``"plan"``
for the plan's own. :func:`gn_bwd_sums_plan`'s constants were chosen from
its output. The wrappers' host cost and B5's check at the main paths' own
inputs are ``chip_smoke.py``'s (its kernel_gn and gn_host phases).

Times are device ms per call: back-to-back calls between two CUDA events,
queued behind a spin kernel, the median of several loops
(:func:`ldm3d_torch.tools.conv_ab.cuda_ms`). ``bound_ms`` is the bytes (x and
dy once, the two fp32 outputs and mean and inv) over 3.35 TB/s.

    python -m ldm3d_torch.tools.gn_sweep                    # stage 1's and stage 2's inputs
    python -m ldm3d_torch.tools.gn_sweep --shape 1,64,64,64,64
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ldm3d_torch.ops import groupnorm as G
from ldm3d_torch.tools.conv_ab import HBM_BYTES_PER_S, cuda_ms

# (B, C, D, H, W): the GroupNorm inputs of a stage-1 step (the VAE at the 64^3
# patch, the discriminator's instance norms) and of a stage-2 step (the
# UNet at batch 20, 80^3 volumes, 20^3 latents)
STAGE1 = ((1, 64, 64, 64, 64), (1, 128, 64, 64, 64), (1, 64, 32, 32, 32), (1, 128, 32, 32, 32),
          (1, 256, 32, 32, 32), (1, 128, 16, 16, 16), (1, 256, 16, 16, 16), (1, 64, 16, 16, 16),
          (1, 128, 8, 8, 8))
STAGE2 = ((20, 256, 20, 20, 20), (20, 512, 20, 20, 20), (20, 768, 20, 20, 20),
          (20, 256, 10, 10, 10), (20, 512, 10, 10, 10), (20, 768, 10, 10, 10),
          (20, 1024, 10, 10, 10), (20, 1536, 10, 10, 10), (20, 512, 5, 5, 5),
          (20, 1024, 5, 5, 5), (20, 1536, 5, 5, 5), (20, 2048, 5, 5, 5))
CHUNKS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 264, 392, 528, 792, 1056)
SUM_REL = 1e-5


def candidates(plan: G.GnPlan) -> dict[str, G.GnPlan]:
    """``plan`` and the plans with each of CHUNKS voxel chunks instead (no
    empty chunk, at least one voxel row a thread), at 2 to 8 chunks with and
    without a cluster."""
    out = {"plan": plan}
    groups, _, b = plan.grid
    for n in CHUNKS:
        chunk = -(-plan.v // n)
        nsplit = -(-plan.v // chunk)
        if chunk < plan.rows:
            continue
        for cluster in ((False, True) if 1 < nsplit <= 8 else (False,)):
            out[f"{nsplit}{'c' if cluster else ''}"] = plan._replace(
                nsplit=nsplit, chunk=chunk, cluster=cluster, grid=(groups, nsplit, b))
    return out


def run_shape(shape, dtype: str, seed: int = 1) -> dict:
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5 + 0.3).to(dt).contiguous(
        memory_format=torch.channels_last_3d)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt).contiguous(
        memory_format=torch.channels_last_3d)
    xf = x.float()
    mean = xf.mean(dim=(2, 3, 4))
    inv = torch.rsqrt(xf.var(dim=(2, 3, 4)) + 1e-6)
    want = G.gn_bwd_sums_reference(dy, x, mean, inv)
    dyf = dy.float()
    tols = [SUM_REL * t.abs().sum(dim=(2, 3, 4), dtype=torch.float64)
            for t in (dyf, dyf * (xf - mean[..., None, None, None]) * inv[..., None, None, None])]
    del xf, dyf
    b, c = shape[:2]
    v = math.prod(shape[2:])
    plan = G.gn_bwd_sums_plan_of(dy, x, mean, inv, cached=False)
    out = torch.empty((2, b, c), device="cuda")
    ms = {}
    for name, p in candidates(plan).items():
        def launch(p=p):
            err = G._launch_bwd_sums(p, dy.data_ptr(), x.data_ptr(), mean, inv, out, dt, x.device)
            if err != 0:
                raise RuntimeError(f"cudaError {err} under {p}")

        launch()
        torch.cuda.synchronize()
        for got, w, tol in zip(out, want, tols):
            if not bool(((got.double() - w.double()).abs() <= tol).all()):
                raise AssertionError(f"gn_bwd_sums differs from plain at {shape} {dtype} under {p}")
        ms[name] = cuda_ms(launch, calls=20, reps=5, warmup=3)
    nbytes = 2.0 * b * v * c * x.element_size() + 16.0 * b * c
    best = min((k for k in ms if k != "plan"), key=ms.get)
    return {"shape": list(shape), "dtype": dtype, "vec": plan.vec, "groups": plan.grid[0],
            "plan_nsplit": plan.nsplit, "plan_cluster": plan.cluster,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ms": ms, "best": best,
            "plan_over_best": ms["plan"] / ms[best]}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default=None, help="B,C,D,H,W (default: STAGE1 and STAGE2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gn_sweep measures the CUDA kernel and needs a CUDA device")
    shapes = [tuple(int(s) for s in args.shape.split(","))] if args.shape else STAGE1 + STAGE2
    recs = []
    for shape in shapes:
        for dtype in ("bfloat16", "float32"):
            recs.append(run_shape(shape, dtype))
            print(json.dumps(recs[-1]), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "inputs": len(recs)}), flush=True)
    return recs


if __name__ == "__main__":
    main()
