"""Evaluation CLI: score the trained LDM on the validation set, gate CI.

The port of ``ldm3d_tpu/cli/evaluate.py``: loads both stage checkpoints (or
the distilled student with ``--use-distilled``), samples conditioned volumes
for the validation pairs through the inference CLI's sampler
(:func:`ldm3d_torch.cli.inference.build_sampler`), scores them against their
high-count partners with :func:`ldm3d_torch.evaluation.evaluate_pairs` (3-D
SSIM, MS-SSIM, PSNR, MAE and the VAE-latent Fréchet distance), writes
``evaluation_report.json``, and with ``--gate`` exits 1 when the composite
score is at or below ``--threshold``. It exits 3 when the validation set
gives no batch.

Randomness: one ``torch.Generator().manual_seed(seed)`` on the CPU gives, a
batch, the condition's posterior noise, the initial noise and a noisy
sampler's step noises, each moved to the device.

Usage: python -m ldm3d_torch.cli.evaluate -c CONFIG -e ENV [-n NUM]
       [--sampler ddim --steps 50] [--timestep-spacing S] [--batch B]
       [--guidance W] [--use-ema | --use-distilled] [--gate --threshold 0.8]
       [--report PATH] [--amp] [--device cuda|cpu]
The flags of the JAX parser whose paths are not ported (``--spatial`` among
them) raise ``NotImplementedError`` naming their ROADMAP item
(``ldm3d_torch.cli.common.UNPORTED``).
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import torch

from ldm3d_torch.cli.common import (
    SAMPLERS,
    TIMESTEP_SPACINGS,
    build_parser,
    cli_main,
    env_seed,
    load_two_stage,
    make_sampling_scheduler,
    model_dtype,
    reject_unported,
    setup,
)
from ldm3d_torch.cli.inference import (
    _sync,
    build_sampler,
    check_distilled_args,
    load_distilled_sampler,
)
from ldm3d_torch.data import prepare_dataloader
from ldm3d_torch.evaluation import evaluate_pairs
from ldm3d_torch.utils import TrainContext

log = logging.getLogger("evaluate")


def build_parser_evaluate():
    parser = build_parser("latent diffusion model evaluation (PyTorch port)")
    parser.add_argument("-n", "--num", type=int, default=8,
                        help="max validation pairs to evaluate")
    parser.add_argument("--sampler", choices=SAMPLERS, default="ddim")
    parser.add_argument("--timestep-spacing", choices=TIMESTEP_SPACINGS, default=None,
                        help="inference grid (default: the config's, else leading); karras is "
                             "for ddim/dpm/dpm3 only")
    parser.add_argument("--steps", type=int, default=None,
                        help="inference steps (50 for ddim/dpm; the full schedule for ddpm)")
    parser.add_argument("--batch", type=int, default=1, help="volumes per sample call")
    parser.add_argument("--guidance", type=float, default=1.0,
                        help="classifier-free guidance scale (1.0 = off)")
    parser.add_argument("--use-ema", action="store_true", help="evaluate the EMA UNet weights")
    parser.add_argument("--use-distilled", action="store_true",
                        help="evaluate the progressively-distilled student on its few-step "
                             "grid (cli.distill)")
    parser.add_argument("--threshold", type=float, default=0.8,
                        help="composite-score gate (the reference CI uses 0.8)")
    parser.add_argument("--gate", action="store_true",
                        help="exit 1 when score <= threshold (the CI registration gate)")
    parser.add_argument("--report", default=None,
                        help="report path (default: <model_dir>/evaluation_report.json)")
    return parser


@cli_main
def main(argv=None, timings: dict | None = None):
    """Run the CLI; returns the :class:`~ldm3d_torch.evaluation.EvalReport`.
    When ``timings`` is a dict it receives, a batch, the sampler's
    ``sample_ms``, ``denoise_ms`` and ``decode_ms`` (see
    ``cli.inference.main``) and ``encode_ms``, and once ``metrics_ms``, the
    host ms of :func:`evaluate_pairs` to its result."""
    args = build_parser_evaluate().parse_args(argv)
    reject_unported(args, data_parallel=False)
    args, device = setup(args)
    dt = model_dtype(args)
    if timings is None:
        timings = {}
    for key in ("encode_ms", "denoise_ms", "decode_ms", "sample_ms"):
        timings.setdefault(key, [])
    patch_size = args.diffusion_train["patch_size"]
    sched_cfg = TrainContext(args).scheduler_config()

    if args.use_distilled:
        check_distilled_args(args)
    else:
        scheduler = make_sampling_scheduler(args.sampler, args.steps, sched_cfg,
                                            timestep_spacing=args.timestep_spacing)
    ae, unet, latent_shape, scale_factor = load_two_stage(args, device, dt,
                                                          use_ema=args.use_ema)
    if args.use_distilled:
        unet, scheduler, scale_factor = load_distilled_sampler(args, unet, sched_cfg, device,
                                                               scale_factor, "ddim")
    conditional = unet.in_channels > ae.latent_channels
    if not conditional:
        log.warning("unconditional UNet: paired metrics compare unconditional samples "
                    "to validation labels — expect a low score")
    latent_batch_shape = (args.batch, *latent_shape, ae.latent_channels)
    cond_shape = ((args.batch, *latent_shape, unet.in_channels - ae.latent_channels)
                  if conditional else None)
    run = build_sampler(args, ae, unet, scheduler, scale_factor, latent_batch_shape, dt, device,
                        condition_shape=cond_shape, timings=timings)

    _, val_loader = prepare_dataloader(
        args, args.batch, patch_size, randcrop=False,
        size_divisible=2 ** (len(args.autoencoder_def["channels"])
                             + len(args.diffusion_def["channels"]) - 2))
    gen = torch.Generator().manual_seed(env_seed(args))
    generated, references = [], []
    n_done = 0
    for batch in val_loader.epoch(0):
        if n_done >= args.num:
            break
        images = torch.from_numpy(np.clip(batch["image"], 0, 1)).to(device, dt)
        labels = np.clip(batch["label"], 0, 1).astype(np.float32)
        condition = None
        if conditional:
            eps = torch.randn(latent_batch_shape, generator=gen)
            t0 = _sync(device)
            with torch.no_grad():
                condition = ae.encode_stage_2_inputs(images, eps.to(device))
            timings["encode_ms"].append((_sync(device) - t0) * 1e3)
        noise = torch.randn(latent_batch_shape, generator=gen).to(device, dt)
        vols, ms = run(noise, condition, gen)
        for key, value in ms.items():
            timings[key].append(value)
        # trim to --num and to the set's true size: the val loader pads a
        # partial batch by repeating its last pair, which must not count twice
        take = min(args.batch, args.num - n_done, len(val_loader.dataset) - n_done)
        if take <= 0:
            break
        generated.append(vols.float().cpu().numpy()[:take])
        references.append(labels[:take])
        n_done += take
        log.info("evaluated %d/%d pairs", n_done, args.num)

    if not generated:
        log.error("validation set produced no full batches of size %d", args.batch)
        sys.exit(3)  # distinct from argparse's usage-error exit code 2

    t0 = _sync(device)
    report = evaluate_pairs(generated, references, ae=ae)
    timings["metrics_ms"] = (_sync(device) - t0) * 1e3
    path = args.report or os.path.join(args.model_dir, "evaluation_report.json")
    report.save(path)
    log.info("wrote %s (score=%.4f, threshold=%.2f)", path, report.score, args.threshold)
    if args.gate and not report.passed(args.threshold):
        log.error("GATE FAILED: score %.4f <= threshold %.2f", report.score, args.threshold)
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
