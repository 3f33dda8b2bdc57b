"""Inference CLI: generate volumes with the trained two-stage LDM.

The port of ``ldm3d_tpu/cli/inference.py``:

1. the VAE encoder turns the low-count volume into the condition latent
   (``encode_stage_2_inputs``, posterior noise from the seeded generator),
2. the UNet runs the reverse loop of the chosen sampler (ddpm, the default,
   over the full training schedule; ddim; dpm; dpm3) with concat
   conditioning,
3. the result is divided by ``scale_factor``,
4. the decoder decodes it, whole or in chunks of ``--decode-chunk`` volumes,
   and each volume is written as NIfTI.

An unconditional UNet (``in_channels == latent_channels``) skips step 1.
Noise, the ancestral noise of ddpm included, is drawn on the CPU from
``torch.Generator().manual_seed(seed)`` and moved to the device, so a seed
gives the same noise on every device.

Usage: python -m ldm3d_torch.cli.inference -c CONFIG -e ENV [-n NUM]
       [--sampler ddpm|ddim|dpm|dpm3] [--steps N] [--timestep-spacing S]
       [--batch B] [--guidance W] [--use-ema] [--decode-chunk N|auto] [--amp]
       [--device cuda|cpu] [-g 0|1] [--compile]
It takes every flag of the JAX parser, as the JAX CLI does; the training
options among them are read by the trainer only, and the flags whose paths
are not ported raise ``NotImplementedError`` naming their ROADMAP item
(``ldm3d_torch.cli.common.UNPORTED``).
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
    TIMESTEP_SPACINGS,
    build_parser,
    env_seed,
    load_two_stage,
    make_sampling_scheduler,
    model_dtype,
    reject_unported,
    resolve_decode_chunk,
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
    parser.add_argument("--sampler", choices=SAMPLERS, default="ddpm",
                        help="ddpm = the full ancestral loop; ddim = fast; dpm = DPM-Solver++ 2M; "
                             "dpm3 = DPM-Solver++ 3M (use >= 20 steps)")
    parser.add_argument("--timestep-spacing", choices=TIMESTEP_SPACINGS, default=None,
                        help="inference grid (default: the config's, else leading); karras is "
                             "for ddim/dpm/dpm3 only")
    parser.add_argument("--steps", type=int, default=None,
                        help="inference steps (default: 50 capped by the training schedule for "
                             "ddim/dpm/dpm3, the full schedule for ddpm; a value strides ddpm)")
    parser.add_argument("--batch", type=int, default=1, help="volumes per sample call")
    parser.add_argument("--guidance", type=float, default=1.0,
                        help="classifier-free guidance scale (1.0 = off)")
    parser.add_argument("--use-ema", action="store_true",
                        help="sample with the EMA UNet weights (trained with --ema-decay)")
    parser.add_argument("--decode-chunk", default="0",
                        help="decode each sampled batch in chunks of this many volumes (0 = "
                             "whole batch; 'auto' probes the device-to-host rate)")
    parser.add_argument("--use-distilled", action="store_true",
                        help="not ported yet (ROADMAP.md queue A, 'Distillation')")
    parser.add_argument("--fused-decode", action="store_true",
                        help="not ported: one XLA program for loop and decode has no eager "
                             "counterpart (ROADMAP.md queue A, 'CUDA graph of the sampler')")
    args = parser.parse_args(argv)
    reject_unported(args)
    if args.use_distilled:
        raise NotImplementedError("--use-distilled is not ported yet: ROADMAP.md queue A, "
                                  "'Distillation'")
    if args.fused_decode:
        raise NotImplementedError("--fused-decode is not ported: ROADMAP.md queue A, "
                                  "'CUDA graph of the sampler'")
    args, device = setup(args)
    dt = model_dtype(args)
    if timings is None:
        timings = {}
    for key in ("encode_ms", "denoise_ms", "decode_ms"):
        timings.setdefault(key, [])

    scheduler = make_sampling_scheduler(args.sampler, args.steps,
                                        TrainContext(args).scheduler_config(),
                                        timestep_spacing=args.timestep_spacing)
    ae, unet, latent_shape, scale_factor = load_two_stage(args, device, dt,
                                                          use_ema=args.use_ema)
    chunk = resolve_decode_chunk(args.decode_chunk, log, device) or args.batch
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
                                         guidance_scale=args.guidance, generator=gen)
        t1 = _sync(device)
        latents = latents / torch.tensor(scale_factor, dtype=latents.dtype)
        with torch.no_grad():
            parts = [ae.decode_stage_2_outputs(latents[s:s + chunk])
                     for s in range(0, args.batch, chunk)]
        t2 = _sync(device)
        timings["denoise_ms"].append((t1 - t0) * 1e3)
        timings["decode_ms"].append((t2 - t1) * 1e3)
        vols = np.concatenate([p.float().cpu().numpy() for p in parts])
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
