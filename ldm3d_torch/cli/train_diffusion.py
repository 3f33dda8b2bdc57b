"""Stage-2 trainer CLI: conditional latent diffusion over a frozen VAE.

The port of ``ldm3d_tpu/cli/train_diffusion.py`` (its unsharded and
``--cache-latents`` branches): loads the stage-1 ``best`` autoencoder (a hard
requirement), computes the latent ``scale_factor`` from the first batch,
trains the UNet with the epsilon-MSE through concat conditioning (Adam, the
configured LR schedule, global-norm clip 1.0), validates with the same loss
every ``val_interval`` epochs, saves the ``best``/``last`` (and with
``--ema-decay`` the ``ema``) diffusion checkpoints, and periodically samples
one volume conditionally with the DDPM scheduler for TensorBoard.

Randomness: one ``torch.Generator`` on the training device, seeded from the
environment's ``seed``, gives every draw (posterior noise, noise, timesteps,
dropout masks, samples); the UNet's initial weights come from another
generator with the same seed.

Usage: python -m ldm3d_torch.cli.train_diffusion -c CONFIG -e ENV [--amp]
       [--device cuda|cpu] [--max-epochs N] [--cache-latents] [--ema-decay D]
       [--min-snr-gamma G] [--cond-dropout P] [--unconditional] [--no-images]
       [-g 0|1] [--compile] [--experiment NAME]
Every other flag of the JAX parser parses and raises ``NotImplementedError``
naming its ROADMAP item (``ldm3d_torch.cli.common.UNPORTED``).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.cli.common import build_parser, env_seed, model_dtype, reject_unported, setup
from ldm3d_torch.configs import define_instance
from ldm3d_torch.data import LatentCache, prepare_dataloader
from ldm3d_torch.diffusion import DDPMScheduler, inferer
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.obs import MetricsWriter, visualize_one_slice_in_3d_image
from ldm3d_torch.training import (
    Stage2Config,
    TrainState,
    build_lr_schedule,
    compute_scale_factor,
    make_diffusion_optimizer,
    make_stage2_eval_step,
    make_stage2_train_step,
    make_stage2_train_step_latents,
)
from ldm3d_torch.utils import TrainContext

log = logging.getLogger("train_diffusion")

def load_frozen_autoencoder(args, device: torch.device, dtype: torch.dtype):
    """The stage-1 VAE with its ``best`` params, frozen, in eval mode."""
    ckpt = CheckpointManager(args.model_dir, "autoencoder")
    if not ckpt.exists("best"):
        raise FileNotFoundError(f"stage-1 autoencoder checkpoint not found at "
                                f"{ckpt.path('best')}; train stage 1 first")
    with torch.device(device):
        ae = define_instance(args, "autoencoder_def")
    ae.load_state_dict(ckpt.load("best", map_location=device)["state_dict"])
    ae.compute_dtype = dtype
    log.info("loaded trained autoencoder from %s", ckpt.path("best"))
    return ae.eval().requires_grad_(False)


def _sync(device: torch.device) -> float:
    """Host clock after the device finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def build_parser_train():
    parser = build_parser("latent diffusion training, stage 2 (PyTorch port)")
    parser.add_argument("--unconditional", action="store_true",
                        help="train without concat conditioning (UNet in_channels == latent)")
    parser.add_argument("--cond-dropout", type=float, default=0.0,
                        help="per-sample probability of zeroing the condition during training "
                             "(enables classifier-free guidance at inference)")
    parser.add_argument("--min-snr-gamma", type=float, default=0.0,
                        help="Min-SNR loss weighting gamma (0 = off; the paper recommends 5.0)")
    parser.add_argument("--cache-latents", action="store_true",
                        help="encode the dataset's posteriors once and train in latent space")
    return parser


def main(argv=None, timings: dict | None = None) -> float:
    """Run the trainer; returns the best validation loss. When ``timings`` is
    a dict it receives the run's record: lists of wall-clock milliseconds,
    each measured to a device sync, ``train_step_ms`` per step and ``val_ms``
    per validation pass; ``diffusion_loss`` per step; ``val_batches``, the
    batch count of each validation pass; and ``scale_factor``."""
    args = build_parser_train().parse_args(argv)
    reject_unported(args)
    args, device = setup(args)
    dt = model_dtype(args)
    train_cfg = args.diffusion_train
    patch_size = train_cfg["patch_size"]
    if timings is None:
        timings = {}
    for key in ("train_step_ms", "val_ms", "diffusion_loss", "val_batches"):
        timings.setdefault(key, [])

    # data -------------------------------------------------------------------
    size_divisible = 2 ** (len(args.autoencoder_def["channels"])
                           + len(args.diffusion_def["channels"]) - 2)
    batch_size = train_cfg["batch_size"]
    train_loader, val_loader = prepare_dataloader(args, batch_size, patch_size, randcrop=False,
                                                  size_divisible=size_divisible)
    steps_per_epoch = max(1, train_loader.steps_per_epoch())
    seed = env_seed(args)
    gen = torch.Generator(device=device).manual_seed(seed)

    # frozen stage-1 VAE and the latent scale factor from the first batch -----
    ae = load_frozen_autoencoder(args, device, dt)
    first = next(iter(train_loader.epoch(0)))
    labels0 = torch.clamp(torch.from_numpy(first["label"]).to(device), 0, 1)
    f = ae.downsample_factor
    latent_shape = (labels0.shape[0], *[s // f for s in labels0.shape[1:4]], ae.latent_channels)
    eps0 = torch.randn(latent_shape, generator=gen, device=device)
    scale_factor = float(compute_scale_factor(ae, labels0, eps0))
    timings["scale_factor"] = scale_factor
    log.info("scale_factor = %.6f", scale_factor)

    # UNet, schedule, optimizer ------------------------------------------------
    with torch.device(device):
        unet = define_instance(args, "diffusion_def")
    init_weights_(unet, torch.Generator(device=device).manual_seed(seed))
    unet.compute_dtype = dt
    sched_cfg = TrainContext(args).scheduler_config()
    scheduler = DDPMScheduler.create(
        num_train_timesteps=sched_cfg["num_train_timesteps"],
        schedule=sched_cfg.get("schedule", "scaled_linear_beta"),
        beta_start=sched_cfg["beta_start"], beta_end=sched_cfg["beta_end"],
        prediction_type=sched_cfg["prediction_type"])
    max_epochs = args.max_epochs or train_cfg["max_epochs"]
    val_interval = train_cfg["val_interval"]
    schedule = build_lr_schedule(train_cfg.get("lr_scheduler", "multistep"), train_cfg["lr"],
                                 max_epochs, steps_per_epoch)
    s2cfg = Stage2Config(conditional=not args.unconditional, cond_dropout=args.cond_dropout,
                         min_snr_gamma=args.min_snr_gamma)
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), schedule),
                       ema_decay=args.ema_decay)

    u_ckpt = CheckpointManager(args.model_dir, "diffusion")
    start_epoch, best_val = 0, float("inf")
    if getattr(args, "resume_ckpt", False):
        restored, ok = u_ckpt.try_restore("last", map_location=device)
        if ok:
            state.load_state_dict(restored)
            meta = restored["meta"]
            start_epoch = int(meta.get("epoch", -1)) + 1
            best_val = float(meta.get("best_val", best_val))
            log.info("resumed diffusion model from epoch %d", start_epoch)
        else:
            log.info("train diffusion model from scratch")

    eval_step = make_stage2_eval_step(unet, ae, scheduler, s2cfg)
    if args.cache_latents:
        cache = LatentCache.build(ae, train_loader.dataset, batch_size, device,
                                  conditional=s2cfg.conditional, seed=seed)
        train_step = make_stage2_train_step_latents(unet, scheduler, s2cfg)
    else:
        train_step = make_stage2_train_step(unet, ae, scheduler, s2cfg)

    writer = MetricsWriter(os.path.join(args.tfevent_path, "diffusion"))
    if not args.no_images:
        for axis in range(3):
            writer.add_image(f"train_img_{axis}",
                             visualize_one_slice_in_3d_image(first["image"][0, ..., 0], axis), 1)
            writer.add_image(f"train_label_{axis}",
                             visualize_one_slice_in_3d_image(first["label"][0, ..., 0], axis), 1)

    total_step = state.step
    for epoch in range(start_epoch, max_epochs):
        t0 = time.time()
        losses = []
        unet.train()
        batches = cache.epoch(epoch) if args.cache_latents else train_loader.epoch(epoch)
        for batch in batches:
            if not args.cache_latents:
                batch = {"image": batch["image"], "label": batch["label"]}
            t_step = _sync(device)
            metrics = train_step(state, _to_device(batch, device), scale_factor, gen)
            loss = float(metrics["diffusion_loss"])
            timings["train_step_ms"].append((_sync(device) - t_step) * 1e3)
            losses.append(loss)
            timings["diffusion_loss"].append(loss)
            total_step += 1
            writer.add_scalar("train_diffusion_loss_iter", loss, total_step)
            if total_step % 50 == 0:
                writer.add_scalar("grad_norm_diffusion", metrics["grad_norm"], total_step)
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        log.info("Epoch %d/%d (%.2fs) - diffusion loss %.5f", epoch, max_epochs,
                 time.time() - t0, epoch_loss)
        if epoch % val_interval:
            continue

        unet.eval()
        t_val = _sync(device)
        val_losses, last_batch = [], None
        for batch in val_loader.epoch(epoch):
            vm = eval_step(_to_device({"image": batch["image"], "label": batch["label"]}, device),
                           scale_factor, gen)
            val_losses.append(float(vm["val_diffusion_loss"]))
            last_batch = batch
        timings["val_ms"].append((_sync(device) - t_val) * 1e3)
        timings["val_batches"].append(len(val_losses))
        if val_losses:
            val_loss = float(np.mean(val_losses))
            writer.add_scalar("val_diffusion_loss", val_loss, epoch)
            log.info("Epoch %d val_diffusion_loss: %.5f", epoch, val_loss)
            is_best = val_loss < best_val
            best_val = min(best_val, val_loss)
            meta = {"epoch": epoch, "val_loss": val_loss, "best_val": best_val,
                    "scale_factor": scale_factor}
            u_ckpt.save_best_and_last(state.state_dict(), is_best, meta)
            if is_best:
                if state.ema_params is not None:
                    u_ckpt.save("ema", {"state_dict": state.ema_params}, meta)
                log.info("Got best val noise pred loss; saved to %s", u_ckpt.root)

        # periodic conditional sampling (reference train_diffusion.py:308-333)
        if not args.no_images and epoch % (2 * val_interval) == 0 and last_batch is not None:
            with torch.no_grad():
                img1 = torch.clamp(torch.from_numpy(last_batch["image"][:1]).to(device), 0, 1)
                shape1 = (1, *[s // f for s in img1.shape[1:4]], ae.latent_channels)
                cond = None
                if s2cfg.conditional:
                    eps = torch.randn(shape1, generator=gen, device=device)
                    cond = ae.encode_stage_2_inputs(img1, eps)
                noise = torch.randn(shape1, generator=gen, device=device).to(dt)
                sampled = inferer.sample(unet, ae.decode_stage_2_outputs, scheduler, noise,
                                         condition=cond, scale_factor=scale_factor,
                                         generator=gen)
            sampled = sampled.float().cpu().numpy()
            for axis in range(3):
                writer.add_image(f"val_lowcount_input_{axis}", visualize_one_slice_in_3d_image(
                    last_batch["image"][0, ..., 0], axis), epoch)
                writer.add_image(f"val_highcount_gt_{axis}", visualize_one_slice_in_3d_image(
                    last_batch["label"][0, ..., 0], axis), epoch)
                writer.add_image(f"val_denoised_cond_{axis}", visualize_one_slice_in_3d_image(
                    sampled[0, ..., 0], axis), epoch)

    writer.close()
    log.info("training complete; best val %.5f", best_val)
    return best_val


if __name__ == "__main__":
    main()
