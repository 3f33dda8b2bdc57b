"""Inference CLI: generate volumes with the trained two-stage LDM.

The port of ``ldm3d_tpu/cli/inference.py`` for conditional DDIM sampling:

1. the VAE encoder turns the low-count volume into the condition latent
   (``encode_stage_2_inputs``, posterior noise from the seeded generator),
2. the UNet runs the DDIM reverse loop with concat conditioning,
3. the result is divided by ``scale_factor``,
4. the decoder decodes it, and each volume is written as NIfTI.

An unconditional UNet (``in_channels == latent_channels``) skips step 1.
Noise is drawn on the CPU from ``torch.Generator().manual_seed(seed)`` and
moved to the device, so a seed gives the same noise on every device.

Usage: python -m ldm3d_torch.cli.inference -c CONFIG -e ENV [-n NUM]
       [--sampler ddim] [--steps N] [--batch B] [--guidance W] [--amp]
       [--device cuda|cpu]
"""

from __future__ import annotations

import logging
import os
import time
from datetime import datetime

import numpy as np
import torch

from ldm3d_torch.cli.common import (
    SAMPLERS,
    build_parser,
    env_seed,
    load_two_stage,
    make_sampling_scheduler,
    model_dtype,
    setup,
)
from ldm3d_torch.data import val_condition_volumes
from ldm3d_torch.diffusion import inferer
from ldm3d_torch.utils import TrainContext
from ldm3d_torch.utils.nifti import write_nifti

log = logging.getLogger("inference")


def save_volume(vol: np.ndarray, out_dir: str, stem: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return write_nifti(os.path.join(out_dir, stem + ".nii.gz"), vol.astype(np.float32))


def _sync(device: torch.device) -> float:
    """Host clock after the device finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None, timings: dict | None = None) -> list[str]:
    """Run the CLI; returns the written paths. When ``timings`` is a dict it
    receives lists of per-call wall-clock milliseconds under ``encode_ms``,
    ``denoise_ms`` and ``decode_ms`` (each measured to a device sync)."""
    parser = build_parser("latent diffusion inference (PyTorch port)")
    parser.add_argument("-n", "--num", type=int, default=1,
                        help="number of generation calls (total volumes = num x batch)")
    parser.add_argument("--sampler", choices=SAMPLERS, default="ddim",
                        help="ddim = the ported sampler; ddpm/dpm/dpm3 are not ported yet")
    parser.add_argument("--steps", type=int, default=None,
                        help="inference steps (default 50, capped by the training schedule)")
    parser.add_argument("--batch", type=int, default=1, help="volumes per sample call")
    parser.add_argument("--guidance", type=float, default=1.0,
                        help="classifier-free guidance scale (1.0 = off)")
    args = parser.parse_args(argv)
    args, device = setup(args)
    dt = model_dtype(args)
    if timings is None:
        timings = {}
    for key in ("encode_ms", "denoise_ms", "decode_ms"):
        timings.setdefault(key, [])

    scheduler = make_sampling_scheduler(args.sampler, args.steps,
                                        TrainContext(args).scheduler_config())
    ae, unet, latent_shape, scale_factor = load_two_stage(args, device, dt)
    gen = torch.Generator().manual_seed(env_seed(args))
    patch_size = args.diffusion_train["patch_size"]
    latent_batch_shape = (args.batch, *latent_shape, ae.latent_channels)

    condition = None
    if unet.in_channels > ae.latent_channels:
        images = np.clip(val_condition_volumes(args, args.batch, patch_size), 0, 1)
        eps = torch.randn(latent_batch_shape, generator=gen)
        t0 = _sync(device)
        with torch.no_grad():
            condition = ae.encode_stage_2_inputs(
                torch.from_numpy(images).to(device, dt), eps.to(device))
        timings["encode_ms"].append((_sync(device) - t0) * 1e3)
        log.info("conditional sampling (concat) with condition shape %s", tuple(condition.shape))

    os.makedirs(args.output_dir, exist_ok=True)
    written: list[str] = []
    for i in range(args.num):
        noise = torch.randn(latent_batch_shape, generator=gen).to(device, dt)
        t0 = _sync(device)
        latents = inferer.sample_latents(unet, scheduler, noise, condition,
                                         guidance_scale=args.guidance)
        t1 = _sync(device)
        with torch.no_grad():
            vols = ae.decode_stage_2_outputs(
                latents / torch.tensor(scale_factor, dtype=latents.dtype))
        t2 = _sync(device)
        timings["denoise_ms"].append((t1 - t0) * 1e3)
        timings["decode_ms"].append((t2 - t1) * 1e3)
        vols = vols.float().cpu().numpy()
        log.info("sample %d: %s in %.2fs (%s, %d steps)", i, vols.shape, t2 - t0,
                 args.sampler, len(scheduler.timesteps))
        for b in range(vols.shape[0]):
            stem = datetime.now().strftime(f"synimg_%Y%m%d_%H%M%S_{i}_{b}")
            # single-channel models write bare (D, H, W) volumes
            vol = vols[b, ..., 0] if vols.shape[-1] == 1 else vols[b]
            written.append(save_volume(vol, args.output_dir, stem))
            log.info("wrote %s", written[-1])
    return written


if __name__ == "__main__":
    main()
