"""Stage-1 trainer CLI: the KL autoencoder against a PatchGAN discriminator.

The port of ``ldm3d_tpu/cli/train_autoencoder.py`` (its unsharded path):
random-cropped training patches (``size_divisible`` = 2^(levels - 1)), the
VAE-GAN steps of :mod:`ldm3d_torch.training.stage1` with the adversarial
terms from the first epoch past ``warmup_epochs``, AdamW behind a clip of
0.5 at the configured LR schedule for both models, TensorBoard scalars
every 10 steps and every epoch, validation every ``val_interval`` epochs.

Checkpoints under ``model_dir``: ``autoencoder_last.pt`` holds the whole
resumable state, both models, both optimizers, both update counts, the
random generator's state and (in its meta) the epoch, so a resume
(``resume_ckpt``) continues the run exactly; it is written at each
validation. As in the reference, a resumed run restarts the best validation
loss at inf and the TensorBoard step count at 0: its first validation
rewrites ``best``. ``autoencoder_best.pt`` and ``discriminator_best.pt`` hold each
model's params under ``"state_dict"``, written when the validation loss
improves: the first is what stage 2 (``cli.train_diffusion``) loads.

Randomness: one ``torch.Generator`` on the training device, seeded from the
environment's ``seed``, gives every draw (posterior noise, LPIPS slices);
the models' initial weights come from another generator with the same seed.
LPIPS takes the port's fixed-seed initialisation, or the port's LPIPS
state_dict saved with ``torch.save`` at the environment key
``lpips_weights`` (``tools/jax_to_torch_ckpt.py --lpips`` converts the JAX
package's flax msgpack into one).

Data parallelism (``-g N``, ``--multihost``): each rank trains on its share
of the global batch (``batch_size`` per rank), with the global batch's
posterior noise, its own rows kept, and both models' gradients averaged
over the ranks; the LR is ``scale_lr_for_world(lr, world)``, as the JAX
trainer's; the validation loss is the ranks' mean. ``--zero`` and
``--fsdp`` shard both models' optimizer state (and, under FSDP, their
parameters) with more than one rank. Rank 0 writes the checkpoints.

``--remat full|convs`` checkpoints the VAE's level ResBlocks; ``--grad-accum
k`` applies one update of each model per k batches on their mean gradients.
SIGTERM (:class:`GracefulShutdown`, polled once a batch) saves the
resumable ``last`` with meta ``epoch`` = the interrupted epoch - 1,
``best_val`` and ``preempted: True``, then exits 75; a resume replays that
epoch. ``--profile`` traces steps 2-4 (:class:`StepProfiler`) into
``./profiler_logs``; ``--track`` records the finished run.

Usage: python -m ldm3d_torch.cli.train_autoencoder -c CONFIG -e ENV [--amp]
       [--device cuda|cpu] [--max-epochs N] [--no-images] [-g N] [--multihost]
       [--zero] [--fsdp] [--compile]
       [--remat [full|convs]] [--grad-accum K] [--profile] [--track]
       [--experiment NAME] [--debug-nans]
Every other flag of the JAX parser parses and raises ``NotImplementedError``
naming its ROADMAP item (``ldm3d_torch.cli.common.UNPORTED``); ``--pipeline``
raises the JAX CLI's ``ValueError``.
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
from ldm3d_torch.data import prepare_dataloader
from ldm3d_torch.nn import LPIPS, PatchDiscriminator3D, init_lpips_, init_weights_
from ldm3d_torch.obs import MetricsWriter, StepProfiler, visualize_one_slice_in_3d_image
from ldm3d_torch.parallel import DataParallel, mesh
from ldm3d_torch.training import (
    GracefulShutdown,
    Stage1Config,
    TrainState,
    build_lr_schedule,
    make_optimizer,
    make_stage1_eval_step,
    make_stage1_train_step,
    scale_lr_for_world,
)

log = logging.getLogger("train_autoencoder")

_METRICS = ("recon_loss", "kl_loss", "perceptual_loss", "adv_loss", "g_loss", "g_grad_norm",
            "d_loss")


def _sync(device: torch.device) -> float:
    """Host clock after the device finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def build_lpips(args, dtype: torch.dtype, device: torch.device) -> LPIPS:
    """The frozen LPIPS network: the port's fixed-seed initialisation, or the
    state_dict at the environment key ``lpips_weights`` (a ``.pt`` of the
    port's LPIPS). A flax msgpack is not read: that needs flax."""
    lpips = init_lpips_(LPIPS(compute_dtype=dtype))
    path = getattr(args, "lpips_weights", "")
    if path:
        # a configured path that does not resolve fails: random features
        # would train against another perceptual objective
        if not os.path.exists(path):
            raise FileNotFoundError(f"lpips_weights is set to {path!r} but the file does not "
                                    "exist; unset the key to train with the fixed-seed LPIPS "
                                    "features deliberately")
        if path.endswith(".msgpack"):
            raise NotImplementedError(f"lpips_weights {path!r} is a flax msgpack, which the port "
                                      "does not read (it needs flax): convert it once with "
                                      "python tools/jax_to_torch_ckpt.py --lpips "
                                      f"{path} --lpips-out <file>.pt and point lpips_weights "
                                      "at the .pt")
        state = torch.load(path, map_location="cpu", weights_only=True)
        lpips.load_state_dict(state.get("state_dict", state))
        log.info("loaded LPIPS weights from %s", path)
    else:
        log.info("using fixed-seed LPIPS features (no pretrained weights configured)")
    return lpips.to(device).eval().requires_grad_(False)


def build_discriminator(args) -> PatchDiscriminator3D:
    """The reference's discriminator: 3 layers of 32 channels at the base,
    ``image_channels`` in, one logit channel out (weights as constructed)."""
    return PatchDiscriminator3D(num_layers_d=3, channels=32, in_channels=args.image_channels,
                                out_channels=1)


def _pipeline_refused(args) -> None:
    if args.pipeline > 1:
        raise ValueError("--pipeline applies to stage 2 (the UNet's uniform mid_depth stack); "
                         "the VAE-GAN has no uniform stack to pipeline — use "
                         "--spatial/--tensor/--fsdp for stage 1 (docs/SCALING.md)")


def _gan_last(g_state: TrainState, d_state: TrainState, gen: torch.Generator) -> dict:
    """The resumable stage-1 state: both models, both optimizers, both
    update counts and the random generator's state, in one file."""
    return {"g": g_state.state_dict(), "d": d_state.state_dict(), "generator": gen.get_state()}


@cli_main
def main(argv=None, timings: dict | None = None) -> float:
    """Run the trainer; returns the best validation loss. When ``timings`` is
    a dict it receives the run's record: ``train_step_ms`` per step and
    ``val_ms`` per validation pass (wall-clock ms, each measured to a device
    sync), ``adv_active`` and every step metric (``g_loss``, ``d_loss``, ...)
    per step, ``val_batches`` and ``val_loss`` per validation pass."""
    args = build_parser("VAE-GAN training, stage 1 (PyTorch port)").parse_args(argv)
    _pipeline_refused(args)
    reject_unported(args)
    launched, out = launch_data_parallel(args, main, argv, timings)
    if launched:
        return out
    args, device = setup(args)
    dp = DataParallel.current()
    world = mesh.world()
    dt = model_dtype(args)
    train_cfg = args.autoencoder_train
    if timings is None:
        timings = {}
    for key in ("train_step_ms", "val_ms", "adv_active", "val_batches", "val_loss", *_METRICS):
        timings.setdefault(key, [])

    # data ---------------------------------------------------------------------
    size_divisible = 2 ** (len(args.autoencoder_def["channels"]) - 1)
    batch_size = global_batch_size(train_cfg["batch_size"], world)
    train_loader, val_loader = prepare_dataloader(args, batch_size,
                                                  train_cfg["patch_size"], randcrop=True,
                                                  size_divisible=size_divisible)
    steps_per_epoch = max(1, train_loader.steps_per_epoch())
    log.info("global batch %d, %d steps/epoch", batch_size, steps_per_epoch)
    lpips = build_lpips(args, dt, device) if train_cfg.get("perceptual_weight", 0) else None

    # models, schedule, optimizers ----------------------------------------------
    seed = env_seed(args)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        ae = init_weights_(define_instance(args, "autoencoder_def"), init_gen)
        disc = init_weights_(build_discriminator(args), init_gen)
    ae.compute_dtype = disc.compute_dtype = dt
    if args.remat:
        ae.remat = args.remat
    max_epochs = args.max_epochs or train_cfg["max_epochs"]
    val_interval = train_cfg["val_interval"]
    schedule = build_lr_schedule(train_cfg.get("lr_scheduler"),
                                 scale_lr_for_world(train_cfg["lr"], world), max_epochs,
                                 steps_per_epoch)
    s1cfg = Stage1Config(
        recon_loss=train_cfg.get("recon_loss", "l1"),
        kl_weight=train_cfg["kl_weight"],
        perceptual_weight=train_cfg.get("perceptual_weight", 0.0),
        adv_weight=train_cfg.get("adv_weight", 0.01),
        warmup_epochs=train_cfg.get("warmup_epochs", 5),
    )
    g_state = TrainState(ae, make_optimizer(ae.parameters(), schedule, s1cfg.grad_clip,
                                            grad_accum=args.grad_accum, dp=dp))
    d_state = TrainState(disc, make_optimizer(disc.parameters(), schedule, s1cfg.grad_clip,
                                              grad_accum=args.grad_accum, dp=dp))

    # checkpoints: G and D resume from one 'last' file -----------------------------
    g_ckpt = CheckpointManager(args.model_dir, "autoencoder")
    d_ckpt = CheckpointManager(args.model_dir, "discriminator")
    start_epoch = 0
    if getattr(args, "resume_ckpt", False):
        restored, ok = g_ckpt.try_restore("last", map_location=device)
        if ok:
            g_state.load_state_dict(restored["g"])
            d_state.load_state_dict(restored["d"])
            if "generator" in restored:  # a converted JAX state carries none
                gen.set_state(restored["generator"].cpu())
            meta = restored["meta"]
            start_epoch = int(meta.get("epoch", -1)) + 1
            log.info("resumed autoencoder from epoch %d", start_epoch)
        else:
            log.info("train autoencoder from scratch")
    # as the reference, a resumed run starts both afresh: its first validation
    # writes 'best', and its _iter scalars count from step 1 again
    best_val, total_step = float("inf"), 0
    shard_train_state(g_state, args, dp)
    shard_train_state(d_state, args, dp)

    train_step = make_stage1_train_step(ae, disc, lpips, s1cfg, dp=dp)
    eval_step = make_stage1_eval_step(ae, lpips, s1cfg, dp=dp)
    writer = MetricsWriter(os.path.join(args.tfevent_path, "autoencoder"),
                           enabled=mesh.rank() == 0)
    profiler = StepProfiler("./profiler_logs", enabled=args.profile)
    # SIGTERM -> resumable 'last', exit 75; the previous handler is back on
    # every way out of the block
    with GracefulShutdown() as stop:
        for epoch in range(start_epoch, max_epochs):
            t0 = time.time()
            adv_active = epoch > s1cfg.warmup_epochs
            ae.train()
            disc.train()
            accum: dict[str, list] = {}
            for step, batch in enumerate(train_loader.epoch(epoch)):
                if stop.requested_global:
                    break
                images = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(device)
                t_step = _sync(device)
                metrics = train_step(g_state, d_state, images, adv_active, gen)
                if dp is not None:  # the global batch's metrics, as one process logs them
                    means = dp.mean(torch.stack([metrics[k].float() for k in _METRICS]))
                    metrics = dict(zip(_METRICS, means))
                metrics = {k: float(v) for k, v in metrics.items()}
                timings["train_step_ms"].append((_sync(device) - t_step) * 1e3)
                timings["adv_active"].append(adv_active)
                for k, v in metrics.items():
                    timings[k].append(v)
                    accum.setdefault(k, []).append(v)
                profiler.step()
                if step % 10 == 0:
                    total_step += 1
                    writer.add_scalar("train_recon_loss_iter", metrics["recon_loss"], total_step)
                    writer.add_scalar("train_kl_loss_iter", metrics["kl_loss"], total_step)
                    writer.add_scalar("train_perceptual_loss_iter", metrics["perceptual_loss"],
                                      total_step)
                    if adv_active:
                        writer.add_scalar("train_adv_loss_iter", metrics["adv_loss"], total_step)
                    writer.add_scalar("lr_generator", schedule(g_state.step), total_step)
                if step % 50 == 0:
                    writer.add_scalar("grad_norm_autoencoder", metrics["g_grad_norm"], total_step)

            if stop.requested_global:
                # the interrupted epoch replays on restart (meta epoch = epoch - 1)
                g_ckpt.save("last", _gan_last(g_state, d_state, gen),
                            {"epoch": epoch - 1, "best_val": best_val, "preempted": True})
                log.warning("preempted during epoch %d: saved resumable 'last' checkpoint", epoch)
                break
            means = {k: float(np.mean(v)) for k, v in accum.items()}
            epoch_time = time.time() - t0
            log.info("Epoch %d/%d (%.2fs) - Recon: %.4f, KL: %.4f, Perceptual: %.4f, Adv: %.4f",
                     epoch, max_epochs, epoch_time, means.get("recon_loss", 0),
                     means.get("kl_loss", 0), means.get("perceptual_loss", 0),
                     means.get("adv_loss", 0))
            writer.add_scalar("train_recon_loss_epoch", means.get("recon_loss", 0), epoch)
            writer.add_scalar("train_kl_loss_epoch", means.get("kl_loss", 0), epoch)
            writer.add_scalar("train_perceptual_loss_epoch", means.get("perceptual_loss", 0), epoch)
            writer.add_scalar("epoch_time", epoch_time, epoch)
            if adv_active:
                writer.add_scalar("train_adv_loss_epoch", means.get("adv_loss", 0), epoch)
            if epoch % val_interval:
                continue

            # validation ----------------------------------------------------------------
            ae.eval()
            t_val = _sync(device)
            val_losses, recon, images = [], None, None
            for batch in val_loader.epoch(epoch):
                images = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(device)
                vm, recon = eval_step(images, gen)
                val_losses.append(float(vm["val_recon_loss"]))
            timings["val_ms"].append((_sync(device) - t_val) * 1e3)
            timings["val_batches"].append(len(val_losses))
            if not val_losses:
                continue
            val_loss = float(np.mean(val_losses))
            if dp is not None:  # every rank compares the same number
                val_loss = dp.mean_of(val_loss, device)
            timings["val_loss"].append(val_loss)
            log.info("Epoch %d val_recon_loss: %.4f", epoch, val_loss)
            writer.add_scalar("val_recon_loss", val_loss, epoch)
            is_best = val_loss < best_val
            best_val = min(best_val, val_loss)
            meta = {"epoch": epoch, "val_loss": val_loss, "best_val": best_val}
            g_ckpt.save("last", _gan_last(g_state, d_state, gen), meta)
            if is_best:
                g_ckpt.save("best", {"state_dict": g_state.model_state_dict()}, meta)
                d_ckpt.save("best", {"state_dict": d_state.model_state_dict()}, meta)
                log.info("Got best val recon loss; saved best checkpoints to %s", args.model_dir)
            if not args.no_images and epoch % (val_interval * 5) == 0:
                img0 = images[0, ..., 0].float().cpu().numpy()
                rec0 = recon[0, ..., 0].float().cpu().numpy()
                for axis in range(3):
                    writer.add_image(f"val_img_{axis}", visualize_one_slice_in_3d_image(img0, axis),
                                     epoch)
                    writer.add_image(f"val_recon_{axis}", visualize_one_slice_in_3d_image(rec0, axis),
                                     epoch)

    profiler.stop()
    writer.close()
    if stop.requested_global:
        # exit 75 (EX_TEMPFAIL): a wrapper must not take a preempted stage
        # for a finished one; the restart resumes and replays the epoch
        log.warning("preempted: resumable state saved; exiting 75 for restart")
        raise SystemExit(75)
    track_run(args, "autoencoder", {"best_val_recon_loss": best_val})
    log.info("training complete; best val %.4f", best_val)
    return best_val


if __name__ == "__main__":
    main()
