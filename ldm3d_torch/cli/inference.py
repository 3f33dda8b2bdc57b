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

``--fused-decode`` runs steps 2-4 as the JAX CLI's one program does, through
:class:`~ldm3d_torch.diffusion.inferer.CapturedSampler`: on the card one
step captured as a CUDA graph, replayed once a step, then the decode's graph,
whole-batch (``--decode-chunk`` is ignored, with the JAX CLI's log line);
the step noises are drawn before the loop, in the eager loop's order, so a
seed writes the same volumes either way. On the CPU the same step body runs
eagerly.

``--use-distilled`` samples the progressively-distilled student
(``cli.distill``): its weights and its few-step GridDDIM grid from the
diffusion model's ``distilled`` checkpoint, in place of ``--sampler`` and
``--steps``; it refuses ``--use-ema``, and ``--guidance`` (the student bakes
its guidance in) before any weights load.

Data-parallel sampling (``-g N``, ``--multihost``; ``ldm3d_tpu/cli/inference.py:60-121``):
``--batch`` is the global batch; every rank draws the global batch's noise
(and its posterior noise and step noises) and keeps its rows, denoises and
decodes them, and rank 0 gathers every rank's volumes and writes them all.
A ``--batch`` the world does not divide is sampled whole on every rank (JAX
then samples on one chip) and still written once.

Depth-sharded sampling (``--spatial S``, ``ldm3d_tpu/cli/inference.py:240-275``):
the ranks form ``-g / S`` data replicas of S ranks; ``--batch`` must divide
by the replicas (JAX's message); each rank keeps its rows and one depth slab
of every draw, encodes the condition through the spatial encoder and runs
the spatial sampler (halo convolutions, group-summed GroupNorm,
gathered-kv attention, the decode included); rank 0 gathers the slabs and
the replicas' rows and writes the volumes. The latent depth must divide by
``S * 2^(len(unet channels) - 1)``. ``--fused-decode`` and
``--decode-chunk`` are not applied under ``--spatial`` (logged), as JAX's
spatial branch reads neither.

An unconditional UNet (``in_channels == latent_channels``) skips step 1.
Noise, the ancestral noise of ddpm included, is drawn on the CPU from
``torch.Generator().manual_seed(seed)`` and moved to the device, so a seed
gives the same noise on every device.

Usage: python -m ldm3d_torch.cli.inference -c CONFIG -e ENV [-n NUM]
       [--sampler ddpm|ddim|dpm|dpm3] [--steps N] [--timestep-spacing S]
       [--batch B] [--guidance W] [--use-ema] [--decode-chunk N|auto] [--amp]
       [--use-distilled] [--fused-decode] [--device cuda|cpu] [-g N] [--spatial S]
       [--multihost] [--compile]
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
    cli_main,
    env_seed,
    launch_data_parallel,
    load_distilled,
    load_distilled_meta,
    load_two_stage,
    make_sampling_scheduler,
    model_dtype,
    reject_unported,
    resolve_decode_chunk,
    setup,
)
from ldm3d_torch.data import val_condition_volumes
from ldm3d_torch.diffusion import inferer
from ldm3d_torch.parallel import DataParallel, MeshSpec, dp_sample_placer, global_batch, mesh
from ldm3d_torch.parallel.spatial import (
    SpatialGroup,
    make_spatial_encoder,
    make_spatial_sampler,
    shard_volume,
    validate_spatial_divisibility,
)
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


def build_sampler(args, ae, unet, scheduler, scale_factor: float, latent_batch_shape,
                  dtype: torch.dtype, device: torch.device, condition_shape=None,
                  timings: dict | None = None, place=None, n_shards: int = 1):
    """The sampler of ``args``: the counterpart of the JAX CLI's
    ``build_sampler_fn``, shared by this CLI and ``cli.evaluate``.

    Returns ``run(noise, condition, generator) -> (volumes, ms)``: the reverse
    loop from ``noise``, ``/ scale_factor`` and the decode, the volumes as one
    device tensor, and ``ms`` the call's ``denoise_ms``, ``decode_ms`` and
    ``sample_ms`` (see :func:`main`). ``generator`` gives a noisy sampler's
    step noises. With ``args.fused_decode`` it runs through
    :class:`~ldm3d_torch.diffusion.inferer.CapturedSampler`, captured here on
    the card (``timings`` receives ``capture_ms``, ``capture_graphs`` and
    ``warmup_launches``); else eagerly, decoding in chunks of
    ``args.decode_chunk`` volumes. ``args`` without those attributes (the
    evaluate CLI's) samples eagerly and decodes whole batches.

    Data-parallel sampling: ``latent_batch_shape`` is this rank's, ``place``
    takes this rank's rows of a global batch of ``n_shards`` ranks' rows
    (:func:`ldm3d_torch.parallel.dp_sample_placer`); a noisy sampler's step
    noises are then drawn for the global batch and placed."""
    batch = latent_batch_shape[0]
    global_shape = (batch * n_shards, *latent_batch_shape[1:])
    per_rank_noise = place is not None and getattr(scheduler, "draws_noise", False)
    place = place or (lambda x: x)

    def step_noises(generator):
        return [place(torch.randn(global_shape, generator=generator))
                for _ in scheduler.timesteps]

    chunk = resolve_decode_chunk(getattr(args, "decode_chunk", 0) or 0, log, device)
    fused = None
    if getattr(args, "fused_decode", False):
        if chunk:
            log.info("--decode-chunk ignored: --fused-decode compiles the reverse "
                     "loop + whole-batch decode as one program")
        fused = inferer.CapturedSampler(
            unet, ae.decode_stage_2_outputs, scheduler, latent_batch_shape, dtype, device,
            condition_shape=condition_shape, guidance_scale=args.guidance,
            scale_factor=scale_factor)
        if device.type == "cuda":
            fused.capture()
            if timings is not None:
                timings.setdefault("capture_ms", []).append(fused.capture_ms)
                timings.setdefault("capture_graphs", []).append(fused.graph_count)
                timings.setdefault("warmup_launches", []).append(fused.warmup_launches)
    chunk = chunk or batch

    def run(noise: torch.Tensor, condition, generator: torch.Generator):
        t0 = _sync(device)
        if fused is not None:
            # the eager loop's draws, in its order: one a step where it draws
            vols = fused.sample(noise, condition,
                                step_noises(generator) if fused.draws_noise else None)
            t2 = _sync(device)
            ms = dict(fused.last_ms)
        else:
            latents = inferer.sample_latents(unet, scheduler, noise, condition,
                                             guidance_scale=args.guidance, generator=generator,
                                             step_noises=step_noises(generator)
                                             if per_rank_noise else None)
            t1 = _sync(device)
            latents = latents / torch.tensor(scale_factor, dtype=latents.dtype)
            with torch.no_grad():
                vols = torch.cat([ae.decode_stage_2_outputs(latents[s:s + chunk])
                                  for s in range(0, batch, chunk)])
            t2 = _sync(device)
            ms = {"denoise_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3}
        ms["sample_ms"] = (t2 - t0) * 1e3
        return vols, ms

    return run


@cli_main
def main(argv=None, timings: dict | None = None) -> list[str]:
    """Run the CLI; returns the written paths. When ``timings`` is a dict it
    receives lists of per-call milliseconds under ``encode_ms``,
    ``denoise_ms`` and ``decode_ms`` (each measured to a device sync; with
    ``--fused-decode`` the last two are device times from CUDA events, which
    leave out the step noises' draws and copy), and ``sample_ms``, the host
    time of a sample either way: from before its loop (eager) or its step
    noises' draws (fused) to the end of its decode, to a device sync. With
    ``--fused-decode`` on the card, the graphs are captured before the first
    sample: ``capture_ms`` holds the host time of the warm-up and the
    captures, ``capture_graphs`` the number of graphs captured, and
    ``warmup_launches`` the kernel launches of the warm-up, as
    ``ldm3d_torch.ops.graphs.launch_delta`` dicts."""
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
                        help="sample the progressively-distilled student (cli.distill) on its "
                             "few-step grid; overrides --sampler/--steps with the GridDDIM "
                             "schedule in the 'distilled' checkpoint's meta")
    parser.add_argument("--fused-decode", action="store_true",
                        help="run the reverse loop and the whole-batch decode as replays of "
                             "CUDA graphs (one step graph replayed a step, one decode graph)")
    args = parser.parse_args(argv)
    reject_unported(args, spatial=True)
    launched, out = launch_data_parallel(args, main, argv, timings)
    if launched:
        return out
    args, device = setup(args)
    lay = mesh.set_layout(MeshSpec(spatial=args.spatial))
    sg = SpatialGroup.current()
    if sg is not None and args.batch % lay.data:
        raise ValueError(
            f"--batch {args.batch} must be divisible by the data axis "
            f"({lay.data} = devices/spatial); e.g. use -g {lay.spatial} "
            f"--spatial {lay.spatial} to devote all devices to one volume")
    place, n_shards = dp_sample_placer(args.batch)
    if sg is not None:  # this rank's rows, then its depth slab
        rows = place
        place = lambda x: shard_volume(rows(x), sg)  # noqa: E731
    elif n_shards == 1 and mesh.world() > 1:
        log.warning("--batch %d not divisible by %d data-parallel ranks; every rank samples "
                    "the whole batch (pick --batch as a multiple to split it)", args.batch,
                    mesh.world())
    dt = model_dtype(args)
    if timings is None:
        timings = {}
    for key in ("encode_ms", "denoise_ms", "decode_ms", "sample_ms"):
        timings.setdefault(key, [])

    sched_cfg = TrainContext(args).scheduler_config()
    if args.use_distilled:
        check_distilled_args(args)
    else:
        scheduler = make_sampling_scheduler(args.sampler, args.steps, sched_cfg,
                                            timestep_spacing=args.timestep_spacing)
    ae, unet, latent_shape, scale_factor = load_two_stage(args, device, dt,
                                                          use_ema=args.use_ema)
    sampler_name = args.sampler
    if args.use_distilled:
        unet, scheduler, scale_factor = load_distilled_sampler(args, unet, sched_cfg, device,
                                                               scale_factor, "ddpm")
        sampler_name = "distilled"
    gen = torch.Generator().manual_seed(env_seed(args))
    patch_size = args.diffusion_train["patch_size"]
    latent_batch_shape = (args.batch, *latent_shape, ae.latent_channels)
    local_shape = (args.batch // n_shards, *latent_batch_shape[1:])
    if sg is not None:
        validate_spatial_divisibility(latent_shape[0], sg.size,
                                      len(args.diffusion_def["channels"]) - 1)

    condition = None
    if unet.in_channels > ae.latent_channels:
        images = place(np.clip(val_condition_volumes(args, args.batch, patch_size), 0, 1))
        eps = place(torch.randn(latent_batch_shape, generator=gen))
        encode = (ae.encode_stage_2_inputs if sg is None
                  else make_spatial_encoder(ae, sg))
        t0 = _sync(device)
        with torch.no_grad():
            condition = encode(torch.from_numpy(np.ascontiguousarray(images)).to(device, dt),
                               eps.to(device))
        timings["encode_ms"].append((_sync(device) - t0) * 1e3)
        log.info("conditional sampling (concat) with condition shape %s", tuple(condition.shape))

    if sg is None:
        run = build_sampler(args, ae, unet, scheduler, scale_factor, local_shape, dt, device,
                            condition_shape=None if condition is None else tuple(condition.shape),
                            timings=timings, place=place if n_shards > 1 else None,
                            n_shards=n_shards)
    else:
        run = _spatial_run(args, ae, unet, scheduler, scale_factor, sg, device)
    lead = mesh.rank() == 0
    if lead:
        os.makedirs(args.output_dir, exist_ok=True)
    written: list[str] = []
    for i in range(args.num):
        noise = place(torch.randn(latent_batch_shape, generator=gen)).to(device, dt)
        out, ms = run(noise, condition, gen)
        for key, value in ms.items():
            timings[key].append(value)
        if sg is not None:  # the slabs put together, then the replicas' rows
            out = sg.all_gather(out, 1)
            if n_shards > 1:
                out = global_batch(out, group=lay.data_group)
        elif n_shards > 1:  # every rank's volumes to rank 0, in rank order
            out = global_batch(out)
        if not lead:
            continue
        vols = out.float().cpu().numpy()
        log.info("sample %d: %s in %.2fs (%s, %d steps%s)", i, vols.shape, ms["sample_ms"] / 1e3,
                 sampler_name, len(scheduler.timesteps), ", fused" if args.fused_decode else "")
        for b in range(vols.shape[0]):
            stem = datetime.now().strftime(f"synimg_%Y%m%d_%H%M%S_{i}_{b}")
            # single-channel models write bare (D, H, W) volumes
            vol = vols[b, ..., 0] if vols.shape[-1] == 1 else vols[b]
            written.append(save_volume(vol, args.output_dir, stem))
            log.info("wrote %s", written[-1])
    return written


def _spatial_run(args, ae, unet, scheduler, scale_factor: float, sg, device):
    """The depth-sharded sampler as ``run(noise, condition, generator) ->
    (this rank's slab of the volumes, ms)``; ``ms`` holds ``sample_ms``."""
    if args.fused_decode or str(args.decode_chunk) != "0":
        log.info("--fused-decode and --decode-chunk are not applied under --spatial: the "
                 "spatial sampler runs the eager loop and decodes whole slabs")
    sampler = make_spatial_sampler(unet, ae, scheduler, sg, scale_factor=scale_factor,
                                   guidance_scale=args.guidance, dp=DataParallel.current())

    def run(noise: torch.Tensor, condition, generator: torch.Generator):
        t0 = _sync(device)
        vols = sampler(noise, condition, generator)
        return vols, {"sample_ms": (_sync(device) - t0) * 1e3}

    return run


def check_distilled_args(args) -> None:
    """``--use-distilled``'s argument rules, from the checkpoint's meta alone
    (before any weights load): not with ``--use-ema``; no ``--guidance``,
    which the student bakes in at distillation."""
    if args.use_ema:
        raise ValueError("--use-distilled and --use-ema are mutually exclusive roles")
    if args.guidance != 1.0:
        baked = float(load_distilled_meta(args.model_dir).get("guidance_scale", 1.0))
        raise ValueError(
            f"--guidance is unavailable with --use-distilled: the student "
            f"bakes guidance w={baked} in "
            f"(re-run ldm3d-distill --guidance-distill to change it)")


def load_distilled_sampler(args, unet, sched_cfg: dict, device, scale_factor: float,
                           default_sampler: str):
    """The student's weights in ``unet``, its GridDDIM scheduler and its
    scale factor (the meta's, else ``scale_factor``), logging that the flag
    overrides ``--sampler``/``--steps`` when either was set."""
    unet, scheduler, meta = load_distilled(args.model_dir, unet, sched_cfg, device)
    if (args.steps is not None or args.sampler != default_sampler
            or getattr(args, "timestep_spacing", None)):
        log.info("--use-distilled overrides --sampler/--steps/--timestep-spacing")
    log.info("distilled sampler: %d steps on grid %s", len(meta["timesteps"]), meta["timesteps"])
    return unet, scheduler, float(meta.get("scale_factor", scale_factor))


if __name__ == "__main__":
    main()
