"""Stage-2 trainer CLI: conditional latent diffusion over a frozen VAE.

The port of ``ldm3d_tpu/cli/train_diffusion.py`` (its unsharded and
``--cache-latents`` branches): loads the stage-1 ``best`` autoencoder (a hard
requirement), computes the latent ``scale_factor`` from the first batch,
trains the UNet with the epsilon-MSE through concat conditioning (Adam, the
configured LR schedule, global-norm clip 1.0), validates with the same loss
every ``val_interval`` epochs, saves the ``best``/``last`` (and with
``--ema-decay`` the ``ema``) diffusion checkpoints, and periodically samples
one volume conditionally with the DDPM scheduler for TensorBoard. A resume
(``resume_ckpt``) restores the train state from ``last`` and, as in the
reference, restarts the best validation loss at inf and the TensorBoard step
count at 0, so its first validation rewrites ``best``.

Data parallelism (``-g N``, ``--multihost``): each rank loads its share of
the global batch (``batch_size`` per rank, as the JAX trainer's per-device
batch), draws the global batch's noise and keeps its rows, and averages the
gradients over the ranks before the clip; the ``scale_factor`` is the
global batch's std (Σ, Σ² and n all-reduced) and the validation loss the
ranks' mean, so every rank takes the same branch. ``--zero`` shards Adam's
moments (ZeRO-1), ``--fsdp`` the parameters, moments and EMA
(``fully_shard``); both act only with more than one rank, as in JAX. Rank 0
writes the checkpoints (the one-process layout) and TensorBoard.

Depth sharding (``--spatial S``, JAX ``:193-213``): the ``-g N`` ranks form
N / S data replicas of S ranks each (``parallel.mesh.set_layout``); each
replica loads its rows (``batch_size`` per replica) and each of its ranks
keeps one depth slab of them, and the spatial train and eval steps run the
encode and the UNet on the slabs (``make_stage2_train_step(..., sg=)``). The
patch depth must divide by ``S * 2^(len(ae channels) + len(unet channels) -
2)`` (``validate_spatial_divisibility``); ``--cache-latents`` is refused, as
in JAX; the scale factor is the whole-volume encode of the replicas' first
batch, as in JAX; the periodic sample runs through the spatial encoder and
sampler. ``--zero``, ``--fsdp`` and ``--tensor`` do not compose with it yet.

``--remat full|convs`` checkpoints the UNet's ResBlocks (and ``mid_stack``);
``--grad-accum k`` applies one update per k batches on their mean gradient,
the EMA decaying once per update. SIGTERM (:class:`GracefulShutdown`, polled
once a batch) saves the resumable ``last`` with meta ``epoch`` = the
interrupted epoch - 1 and ``preempted: True``, then exits 75; a resume
replays that epoch. ``--track`` records the finished run
(:func:`~ldm3d_torch.cli.common.track_run`); ``--profile`` is accepted and
does nothing here, as in JAX.

Randomness: one ``torch.Generator`` on the training device, seeded from the
environment's ``seed``, gives every draw (posterior noise, noise, timesteps,
dropout masks, samples); the UNet's initial weights come from another
generator with the same seed.

Usage: python -m ldm3d_torch.cli.train_diffusion -c CONFIG -e ENV [--amp]
       [--device cuda|cpu] [--max-epochs N] [--cache-latents] [--ema-decay D]
       [--min-snr-gamma G] [--cond-dropout P] [--unconditional] [--no-images]
       [-g N] [--spatial S] [--multihost] [--zero] [--fsdp] [--compile]
       [--remat [full|convs]]
       [--grad-accum K] [--track] [--experiment NAME] [--debug-nans] [--profile]
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
from ldm3d_torch.cli.common import (
    build_parser,
    cli_main,
    env_seed,
    global_batch_size,
    launch_data_parallel,
    model_dtype,
    reject_unported,
    setup,
    shard_train_state,
    track_run,
)
from ldm3d_torch.configs import define_instance
from ldm3d_torch.data import LatentCache, prepare_dataloader
from ldm3d_torch.diffusion import DDPMScheduler, inferer
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.obs import MetricsWriter, visualize_one_slice_in_3d_image
from ldm3d_torch.parallel import DataParallel, MeshSpec, mesh
from ldm3d_torch.parallel.spatial import (
    SpatialGroup,
    make_spatial_encoder,
    make_spatial_sampler,
    shard_volume,
    validate_spatial_divisibility,
)
from ldm3d_torch.training import (
    GracefulShutdown,
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


def _slabs(batch: dict, sg) -> dict:
    """This rank's depth slab of each volume (the volumes as they are
    without a spatial group)."""
    return batch if sg is None else {k: shard_volume(v, sg) for k, v in batch.items()}


def _spatial_sample(ae, unet, scheduler, sg, img1, shape1, conditional: bool,
                    scale_factor: float, gen, dt):
    """The periodic sample through the spatial encoder and sampler (JAX
    ``:321-339``): the condition's and the noise's draws are the whole
    volume's, cut to this rank's slab; every rank of the group gets the
    gathered volume."""
    cond = None
    if conditional:
        eps = shard_volume(torch.randn(shape1, generator=gen, device=gen.device), sg)
        cond = make_spatial_encoder(ae, sg)(shard_volume(img1, sg), eps)
    noise = shard_volume(torch.randn(shape1, generator=gen, device=gen.device), sg).to(dt)
    sampler = make_spatial_sampler(unet, ae, scheduler, sg, scale_factor=scale_factor)
    return sg.all_gather(sampler(noise, cond, gen), 1)


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


@cli_main
def main(argv=None, timings: dict | None = None) -> float:
    """Run the trainer; returns the best validation loss. When ``timings`` is
    a dict it receives the run's record: lists of wall-clock milliseconds,
    each measured to a device sync, ``train_step_ms`` per step and ``val_ms``
    per validation pass; ``diffusion_loss`` per step; ``val_batches``, the
    batch count of each validation pass; and ``scale_factor``."""
    args = build_parser_train().parse_args(argv)
    reject_unported(args, spatial=True)
    launched, out = launch_data_parallel(args, main, argv, timings)
    if launched:
        return out
    args, device = setup(args)
    mesh.set_layout(MeshSpec(spatial=args.spatial))
    dp, sg = DataParallel.current(), SpatialGroup.current()
    dt = model_dtype(args)
    train_cfg = args.diffusion_train
    patch_size = train_cfg["patch_size"]
    if timings is None:
        timings = {}
    for key in ("train_step_ms", "val_ms", "diffusion_loss", "val_batches"):
        timings.setdefault(key, [])

    # data -------------------------------------------------------------------
    downsamples = len(args.autoencoder_def["channels"]) + len(args.diffusion_def["channels"]) - 2
    size_divisible = 2 ** downsamples
    if sg is not None:
        validate_spatial_divisibility(patch_size[0], sg.size, downsamples)
        if args.cache_latents:
            raise ValueError("--cache-latents is incompatible with --spatial "
                             "(the cache stores whole-volume latents)")
    batch_size = global_batch_size(train_cfg["batch_size"], mesh.data_size())
    train_loader, val_loader = prepare_dataloader(args, batch_size, patch_size, randcrop=False,
                                                  size_divisible=size_divisible)
    steps_per_epoch = max(1, train_loader.steps_per_epoch())
    seed = env_seed(args)
    gen = torch.Generator(device=device).manual_seed(seed)

    # frozen stage-1 VAE and the latent scale factor from the first (global) batch
    ae = load_frozen_autoencoder(args, device, dt)
    first = next(iter(train_loader.epoch(0)))
    labels0 = torch.clamp(torch.from_numpy(first["label"]).to(device), 0, 1)
    f = ae.downsample_factor
    latent_shape = (batch_size, *[s // f for s in labels0.shape[1:4]], ae.latent_channels)
    eps0 = torch.randn(latent_shape, generator=gen, device=device)
    if dp is not None:
        eps0 = dp.shard(eps0)
    scale_factor = float(compute_scale_factor(ae, labels0, eps0, dp))
    timings["scale_factor"] = scale_factor
    log.info("scale_factor = %.6f", scale_factor)

    # UNet, schedule, optimizer ------------------------------------------------
    with torch.device(device):
        unet = define_instance(args, "diffusion_def")
    init_weights_(unet, torch.Generator(device=device).manual_seed(seed))
    unet.compute_dtype = dt
    if args.remat:
        unet.remat = args.remat
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
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), schedule,
                                                      grad_accum=args.grad_accum, dp=dp),
                       ema_decay=args.ema_decay, ema_every=args.grad_accum)

    u_ckpt = CheckpointManager(args.model_dir, "diffusion")
    start_epoch = 0
    if getattr(args, "resume_ckpt", False):
        restored, ok = u_ckpt.try_restore("last", map_location=device)
        if ok:
            state.load_state_dict(restored)
            meta = restored["meta"]
            start_epoch = int(meta.get("epoch", -1)) + 1
            log.info("resumed diffusion model from epoch %d", start_epoch)
        else:
            log.info("train diffusion model from scratch")
    # as the reference, a resumed run starts both afresh: its first validation
    # writes 'best', and its _iter scalars count from step 1 again
    best_val, total_step = float("inf"), 0
    shard_train_state(state, args, dp)

    eval_step = make_stage2_eval_step(unet, ae, scheduler, s2cfg, dp=dp, sg=sg)
    if args.cache_latents:
        cache = LatentCache.build(ae, train_loader.dataset, batch_size, device,
                                  conditional=s2cfg.conditional, seed=seed)
        train_step = make_stage2_train_step_latents(unet, scheduler, s2cfg, dp=dp)
    else:
        train_step = make_stage2_train_step(unet, ae, scheduler, s2cfg, dp=dp, sg=sg)

    writer = MetricsWriter(os.path.join(args.tfevent_path, "diffusion"),
                           enabled=mesh.rank() == 0)
    if not args.no_images:
        for axis in range(3):
            writer.add_image(f"train_img_{axis}",
                             visualize_one_slice_in_3d_image(first["image"][0, ..., 0], axis), 1)
            writer.add_image(f"train_label_{axis}",
                             visualize_one_slice_in_3d_image(first["label"][0, ..., 0], axis), 1)

    # SIGTERM -> resumable 'last', exit 75; the previous handler is back on
    # every way out of the block
    with GracefulShutdown() as stop:
        for epoch in range(start_epoch, max_epochs):
            t0 = time.time()
            losses = []
            unet.train()
            batches = cache.epoch(epoch) if args.cache_latents else train_loader.epoch(epoch)
            for batch in batches:
                if stop.requested_global:
                    break
                if not args.cache_latents:
                    batch = _slabs({"image": batch["image"], "label": batch["label"]}, sg)
                t_step = _sync(device)
                metrics = train_step(state, _to_device(batch, device), scale_factor, gen)
                if dp is not None:  # the global batch's loss, as one process logs it
                    metrics["diffusion_loss"] = dp.mean(metrics["diffusion_loss"])
                loss = float(metrics["diffusion_loss"])
                timings["train_step_ms"].append((_sync(device) - t_step) * 1e3)
                losses.append(loss)
                timings["diffusion_loss"].append(loss)
                total_step += 1
                writer.add_scalar("train_diffusion_loss_iter", loss, total_step)
                if total_step % 50 == 0:
                    writer.add_scalar("grad_norm_diffusion", metrics["grad_norm"], total_step)
            if stop.requested_global:
                # the interrupted epoch replays on restart (meta epoch = epoch - 1)
                u_ckpt.save("last", state.state_dict(), {"epoch": epoch - 1, "best_val": best_val,
                                                         "scale_factor": scale_factor,
                                                         "preempted": True})
                log.warning("preempted during epoch %d: saved resumable 'last' checkpoint", epoch)
                break
            epoch_loss = float(np.mean(losses)) if losses else float("nan")
            log.info("Epoch %d/%d (%.2fs) - diffusion loss %.5f", epoch, max_epochs,
                     time.time() - t0, epoch_loss)
            if epoch % val_interval:
                continue

            unet.eval()
            t_val = _sync(device)
            val_losses, last_batch = [], None
            for batch in val_loader.epoch(epoch):
                vm = eval_step(_to_device(_slabs({"image": batch["image"],
                                                  "label": batch["label"]}, sg), device),
                               scale_factor, gen)
                val_losses.append(float(vm["val_diffusion_loss"]))
                last_batch = batch
            timings["val_ms"].append((_sync(device) - t_val) * 1e3)
            timings["val_batches"].append(len(val_losses))
            if val_losses:
                val_loss = float(np.mean(val_losses))
                if dp is not None:  # every rank compares the same number
                    val_loss = dp.mean_of(val_loss, device)
                writer.add_scalar("val_diffusion_loss", val_loss, epoch)
                log.info("Epoch %d val_diffusion_loss: %.5f", epoch, val_loss)
                is_best = val_loss < best_val
                best_val = min(best_val, val_loss)
                meta = {"epoch": epoch, "val_loss": val_loss, "scale_factor": scale_factor}
                u_ckpt.save_best_and_last(state.state_dict(), is_best, meta)
                if is_best:
                    if state.ema_params is not None:
                        u_ckpt.save("ema", {"state_dict": state.ema_state_dict()}, meta)
                    log.info("Got best val noise pred loss; saved to %s", u_ckpt.root)

            # periodic conditional sampling (reference train_diffusion.py:308-333)
            if not args.no_images and epoch % (2 * val_interval) == 0 and last_batch is not None:
                with torch.no_grad():
                    img1 = torch.clamp(torch.from_numpy(last_batch["image"][:1]).to(device), 0, 1)
                    shape1 = (1, *[s // f for s in img1.shape[1:4]], ae.latent_channels)
                    if sg is None:
                        cond = None
                        if s2cfg.conditional:
                            eps = torch.randn(shape1, generator=gen, device=device)
                            cond = ae.encode_stage_2_inputs(img1, eps)
                        noise = torch.randn(shape1, generator=gen, device=device).to(dt)
                        sampled = inferer.sample(unet, ae.decode_stage_2_outputs, scheduler,
                                                 noise, condition=cond,
                                                 scale_factor=scale_factor, generator=gen)
                    else:  # through the spatial encoder and sampler, the slabs gathered
                        sampled = _spatial_sample(ae, unet, scheduler, sg, img1, shape1,
                                                  s2cfg.conditional, scale_factor, gen, dt)
                sampled = sampled.float().cpu().numpy()
                for axis in range(3):
                    writer.add_image(f"val_lowcount_input_{axis}", visualize_one_slice_in_3d_image(
                        last_batch["image"][0, ..., 0], axis), epoch)
                    writer.add_image(f"val_highcount_gt_{axis}", visualize_one_slice_in_3d_image(
                        last_batch["label"][0, ..., 0], axis), epoch)
                    writer.add_image(f"val_denoised_cond_{axis}", visualize_one_slice_in_3d_image(
                        sampled[0, ..., 0], axis), epoch)

    writer.close()
    if stop.requested_global:
        # exit 75 (EX_TEMPFAIL): a wrapper must not take a preempted stage
        # for a finished one; the restart resumes and replays the epoch
        log.warning("preempted: resumable state saved; exiting 75 for restart")
        raise SystemExit(75)
    track_run(args, "diffusion", {"best_val_diffusion_loss": best_val,
                                  "scale_factor": scale_factor})
    log.info("training complete; best val %.5f", best_val)
    return best_val


if __name__ == "__main__":
    main()
