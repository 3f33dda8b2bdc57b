"""Shared CLI plumbing of the port.

The subset of ``ldm3d_tpu/cli/common.py`` that sampling, serving and
training need: the parser (every flag of the JAX ``build_parser``, plus
``--device``) with :func:`reject_unported` for the flags whose paths are
not ported, config merging, the compute dtype, the environment seed, the
device rule, the two-stage checkpoints (``best``, or the UNet's ``ema``), the
sampler and grid-spacing registries with ``make_sampling_scheduler``, and the
decode-chunk choice; the trainers' ``--debug-nans`` mode
(:func:`enable_debug_nans`, scoped to the CLI call by :func:`cli_main`) and
``--track`` (:func:`track_run`).

Device rule: entry points run on ``cuda`` unless the caller passes
``--device cpu``. Without a CUDA device and without ``--device cpu`` they
raise; they never carry on on the CPU.

Precision rule: the port's fp32 is full fp32. PyTorch runs fp32
convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32``), so
every entry point calls :func:`pin_fp32_precision` before any work, which
sets both ``allow_tf32`` flags to False.

Checkpoints: the ``best`` roles of :class:`ldm3d_torch.ckpt.CheckpointManager`,
``model_dir/autoencoder_best.pt`` and ``model_dir/diffusion_best.pt``, each
``{"state_dict": ..., "meta": {...}}``; the latent ``scale_factor`` is in the
diffusion checkpoint's meta. The progressively-distilled student
(``cli.distill``) is the diffusion model's ``distilled`` role, its sampling
grid in the meta; :func:`load_distilled` is the one reader of that meta. The training CLIs write them;
``tools/jax_to_torch_ckpt.py`` converts the JAX package's orbax checkpoints.

Data parallelism: ``-g N`` (N > 1; ``-g 0`` = every visible device) starts
N ranks on this machine (:func:`launch_data_parallel`), one per GPU over
NCCL, or with ``--device cpu`` N processes over gloo; ``--multihost`` (or
any ``torchrun`` launch) joins the process group ``torchrun`` set up, one
process per GPU. Each rank runs the same CLI on its share of the global
batch (:func:`global_batch_size`).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import logging
import os
import sys
import time

import torch

from ldm3d_torch.ckpt.manager import CheckpointManager
from ldm3d_torch.configs import define_instance, preset_path
from ldm3d_torch.utils import merge_configs_onto_args

__all__ = ["SAMPLERS", "TIMESTEP_SPACINGS", "UNPORTED", "build_parser", "reject_unported",
           "launch_data_parallel", "check_axes", "global_batch_size", "shard_train_state", "setup",
           "cli_main", "enable_debug_nans", "disable_debug_nans", "track_run",
           "resolve_device", "pin_fp32_precision", "tf32_flags",
           "model_dtype", "env_seed", "save_two_stage", "load_two_stage",
           "load_distilled_meta", "load_distilled",
           "make_sampling_scheduler", "default_sampler_steps", "probe_readback_gbps",
           "resolve_decode_chunk"]

log = logging.getLogger("ldm3d_torch")

# the one sampler-name registry and the one grid-spacing registry: the CLIs'
# argparse choices, serving validation and make_sampling_scheduler share them
SAMPLERS = ("ddpm", "ddim", "dpm", "dpm3")
TIMESTEP_SPACINGS = ("leading", "trailing", "karras")


def build_parser(description: str) -> argparse.ArgumentParser:
    """The JAX ``build_parser``'s flags, with the same names and defaults,
    plus ``--device``. Both CLIs take all of them, as in JAX; the flags
    whose paths are not ported parse and then raise in
    :func:`reject_unported`."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-e", "--environment-file", default=preset_path("environment.json"),
                   help="environment json file that stores environment paths")
    p.add_argument("-c", "--config-file", default=preset_path("config_train_32g.json"),
                   help="config json file that stores hyper-parameters")
    p.add_argument("-g", "--gpus", default=0, type=int,
                   help="data-parallel ranks (0 = every visible GPU, 1 with --device cpu): "
                        "N > 1 starts one process per GPU over NCCL, or N CPU processes over "
                        "gloo with --device cpu")
    p.add_argument("--amp", action="store_true", help="bf16 compute (parameters stay fp32)")
    p.add_argument("--compile", action="store_true",
                   help="accepted for reference parity; the port runs eager PyTorch and its own "
                        "CUDA kernels, with no torch.compile")
    p.add_argument("--profile", action="store_true",
                   help="stage-1 training: trace steps 2-4 with torch.profiler (CPU and CUDA) "
                        "into ./profiler_logs as a Chrome trace; the other CLIs accept it and "
                        "do nothing, as in JAX")
    p.add_argument("--no-images", action="store_true",
                   help="no slice images and no periodic sample for TensorBoard (training)")
    p.add_argument("--max-epochs", type=int, default=None,
                   help="override config max_epochs (training)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="use generated synthetic pairs when no NPZ dirs are set")
    p.add_argument("--track", action="store_true",
                   help="record the finished run in the local JSON experiment tracker "
                        "(./mlruns_local; the port has no MLflow backend)")
    p.add_argument("--experiment", default="ldm3d-tpu",
                   help="experiment name, read only by --track")
    p.add_argument("--debug-nans", action="store_true",
                   help="debug mode: raise FloatingPointError at the first module whose output "
                        "holds a NaN, and anomaly detection (NaN checks) in the backward; it "
                        "syncs the device after every module, so it is slow")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="training: accumulate the mean gradient over this many micro-batches "
                        "before each optimizer update (optax.MultiSteps semantics)")
    p.add_argument("--remat", nargs="?", const="full", default=None,
                   choices=["full", "convs"],
                   help="training: rematerialize ResBlocks (torch.utils.checkpoint). Bare "
                        "--remat = 'full' (least memory: every forward op of the block reruns "
                        "in the backward); --remat convs keeps the blocks' convolution outputs "
                        "and recomputes the rest (GroupNorm, SiLU)")
    p.add_argument("--spatial", type=int, default=1,
                   help="stage-2 training and sampling: split each volume's depth over this "
                        "many ranks (halo convolutions, group-summed GroupNorm, gathered-kv "
                        "attention); -g must be a multiple of it")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an EMA of the UNet params (e.g. 0.9999), saved as 'ema' (training)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group torchrun set up (RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT, LOCAL_RANK): one process per GPU, across machines")
    p.add_argument("--tensor", type=int, default=1, help="not ported (must be 1)")
    p.add_argument("--zero", action="store_true",
                   help="training: ZeRO-1, Adam's moments sharded over the data-parallel ranks "
                        "(with more than one rank)")
    p.add_argument("--fsdp", action="store_true",
                   help="training: FSDP (fully_shard), parameters, moments and EMA sharded over "
                        "the data-parallel ranks (with more than one rank); supersedes --zero")
    p.add_argument("--pipeline", type=int, default=1, help="not ported (must be 1)")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="not ported (must be 0)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass cpu to run on the CPU)")
    return p


# flags of the JAX parser whose paths are not ported: (attribute, the values
# the port runs, ROADMAP.md queue A item); any other value raises (--spatial
# runs in the CLIs that pass spatial=True to reject_unported)
_PARALLEL = "'Parallelism'"
_PIPELINE = "'UNet mid_depth stack, then pipeline parallelism'"
UNPORTED = (
    ("spatial", (1,), _PARALLEL),
    ("tensor", (1,), _PARALLEL),
    ("pipeline", (1,), _PIPELINE),
    ("pipeline_microbatches", (0,), _PIPELINE),
)
# CLIs without a data-parallel path (evaluation, the checkpoint tools) run on
# one device: for them -g above 1 and --multihost are unported too
_SINGLE_DEVICE = (("gpus", (0, 1), _PARALLEL), ("multihost", (False,), _PARALLEL))


def reject_unported(args, data_parallel: bool = True, spatial: bool = False) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for the first
    flag set to a value whose path is not ported (``data_parallel=False``:
    also ``-g`` above 1 and ``--multihost``). ``spatial=True`` (the stage-2
    trainer and the sampler) runs ``--spatial``, but not yet with
    ``--zero``, ``--fsdp`` or ``--tensor``."""
    if spatial and args.spatial > 1:
        for flag, on in (("--zero", args.zero), ("--fsdp", args.fsdp),
                         ("--tensor", args.tensor != 1)):
            if on:
                raise NotImplementedError(f"--spatial {args.spatial} with {flag} is not ported "
                                          f"yet: ROADMAP.md queue A, {_PARALLEL}")
    for attr, ported, item in UNPORTED + (() if data_parallel else _SINGLE_DEVICE):
        if spatial and attr == "spatial":
            continue
        value = getattr(args, attr)
        if value not in ported:
            flag = "--" + attr.replace("_", "-")
            raise NotImplementedError(f"{flag} {value} is not ported yet: ROADMAP.md queue A, "
                                      f"{item}")


def _requested_ranks(args) -> int:
    """``-g`` as a rank count: 0 is every visible GPU (one process on the
    CPU); more GPUs than are visible raise JAX's ``ValueError``."""
    if torch.device(args.device).type != "cuda":
        return max(1, args.gpus)
    visible = torch.cuda.device_count()
    n = args.gpus if args.gpus > 0 else max(1, visible)
    if n > visible and n > 1:
        raise ValueError(f"requested {n} devices, only {visible} visible")
    return n


def launch_data_parallel(args, main, argv, timings: dict | None = None) -> tuple[bool, object]:
    """Start ``-g N``'s ranks when this process is not one already.

    Returns ``(False, None)`` when this process runs the CLI itself: one
    rank, a rank of a launch (the process group is up), or a ``torchrun``
    process with ``--multihost`` (the process group is initialised here;
    torchrun's environment without ``--multihost`` raises). Otherwise starts
    N ranks, each running ``main(argv)``
    (NCCL with one GPU a rank; gloo and N CPU processes with ``--device
    cpu``), waits for them, and returns
    ``(True, rank 0's result)``, rank 0's ``timings`` copied into
    ``timings``. A rank's error is raised here, every rank killed."""
    from ldm3d_torch.parallel import mesh, multihost

    if torch.distributed.is_available() and torch.distributed.is_initialized():
        n = mesh.world()
        if args.gpus not in (0, n):
            raise ValueError(f"-g {args.gpus} in a process group of {n} ranks")
        check_axes(args, n)
        return False, None
    device_type = torch.device(args.device).type
    if args.multihost:
        _, n = multihost.init_multihost(device_type)
        if args.gpus not in (0, n):
            raise ValueError(f"-g {args.gpus} under torchrun's {n} ranks")
        check_axes(args, n)
        return False, None
    if multihost.torchrun_env():
        raise RuntimeError("torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, "
                           "MASTER_PORT) is set but --multihost is not: pass --multihost to "
                           "join its process group, or unset those variables")
    n = _requested_ranks(args)
    check_axes(args, n)
    if n <= 1:
        return False, None
    from ldm3d_torch.parallel.launch import launch, run_cli

    devices = [f"cuda:{r}" for r in range(n)] if device_type == "cuda" else ["cpu"] * n
    threads = None if device_type == "cuda" else max(1, (os.cpu_count() or 1) // n)
    log.info("data parallel: starting %d ranks on %s", n, ", ".join(devices))
    results = launch(run_cli, n, main, list(argv) if argv is not None else sys.argv[1:],
                     timings is not None, devices=devices, timeout_s=None, threads=threads)
    out, rank0_timings = results[0]
    if timings is not None:
        timings.update(rank0_timings)
    return True, out


def check_axes(args, n: int) -> None:
    """JAX's ``ValueError`` when ``--spatial x --tensor x --pipeline`` does
    not divide the ``n`` ranks (``ldm3d_tpu/cli/common.py:188-190``)."""
    spatial = max(1, getattr(args, "spatial", 1))
    tensor = max(1, getattr(args, "tensor", 1))
    stage = max(1, getattr(args, "pipeline", 1))
    if n % (spatial * tensor * stage):
        raise ValueError(f"--spatial {spatial} x --tensor {tensor} x --pipeline {stage} "
                         f"does not divide {n} devices")


def global_batch_size(per_device_batch: int, world: int) -> int:
    """The configured ``batch_size`` is per replica (reference: one process
    per GPU); the global batch over ``world`` replicas (the data axis's
    size) is ``per_device * world`` (``ldm3d_tpu/cli/common.py:213``)."""
    return per_device_batch * world


def shard_train_state(state, args, dp) -> None:
    """``--fsdp`` (which supersedes ``--zero``) or ``--zero`` over the ranks,
    in place; nothing with one rank, as in JAX."""
    if dp is None:
        return
    if args.fsdp:
        from ldm3d_torch.parallel.fsdp import shard_train_state_fsdp

        if args.zero:
            log.info("--zero is redundant under --fsdp (moments are FSDP-sharded)")
        shard_train_state_fsdp(state, dp)
        log.info("FSDP: params + optimizer state sharded over %d ranks", dp.world)
    elif args.zero:
        from ldm3d_torch.parallel.zero import shard_train_state_zero

        shard_train_state_zero(state, dp)
        log.info("ZeRO-1: optimizer state sharded over %d ranks", dp.world)


def setup(args) -> tuple:
    """Merge the config files onto ``args``, pin the fp32 precision, enter
    the ``--debug-nans`` mode when asked, and resolve the device (under data
    parallelism, this rank's GPU). Ranks other than 0 log warnings only."""
    from ldm3d_torch.parallel import mesh

    logging.basicConfig(
        stream=sys.stdout, level=logging.INFO if mesh.rank() == 0 else logging.WARNING,
        format="[%(asctime)s.%(msecs)03d][%(levelname)5s](%(name)s) - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    if getattr(args, "debug_nans", False):
        enable_debug_nans()
        log.info("debug mode: NaN checks on every module output and in the backward")
    merge_configs_onto_args(args, args.environment_file, args.config_file)
    pin_fp32_precision()
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return args, device


# what enable_debug_nans installed: the anomaly-mode switch, the hook handle
_DEBUG_NANS: list = []


def _nan_check_hook(module, inputs, output) -> None:
    tensors = output if isinstance(output, (tuple, list)) else (output,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"invalid value (nan) encountered in the output of "
                                     f"{type(module).__name__} (--debug-nans)")


def enable_debug_nans() -> None:
    """The port's ``jax_debug_nans``: a global forward hook raises
    ``FloatingPointError`` naming the first module (innermost first) whose
    output holds a NaN, and autograd's anomaly mode with ``check_nan`` raises
    at the backward function that returns one. Each check syncs the device.
    :func:`cli_main` takes both off when the CLI call returns or raises."""
    if _DEBUG_NANS:
        return
    _DEBUG_NANS.append(torch.autograd.set_detect_anomaly(True, check_nan=True))
    _DEBUG_NANS.append(torch.nn.modules.module.register_module_forward_hook(_nan_check_hook))


def disable_debug_nans() -> None:
    """Undo :func:`enable_debug_nans` (a no-op when it is off)."""
    if _DEBUG_NANS:
        anomaly, hook = _DEBUG_NANS
        hook.remove()
        anomaly.__exit__(None, None, None)
        _DEBUG_NANS.clear()


def cli_main(main):
    """A CLI's ``main``, with the process-wide modes its :func:`setup` may
    enter (``--debug-nans``) taken off again when it returns or raises."""

    @functools.wraps(main)
    def run(*args, **kwargs):
        try:
            return main(*args, **kwargs)
        finally:
            disable_debug_nans()

    return run


def track_run(args, stage: str, final_metrics: dict) -> None:
    """Log a finished training run in the experiment tracker when
    ``--track`` is set (``ldm3d_tpu/cli/common.py`` ``track_run``): the
    stage, the config file, ``amp``, the device count and the stage's
    training section as params, ``final_metrics``, and the checkpoints'
    ``best`` metas."""
    if not getattr(args, "track", False):
        return
    from ldm3d_torch.mlops.tracking import ExperimentTracker, log_training_run

    tracker = ExperimentTracker(args.experiment)
    from ldm3d_torch.parallel import mesh

    if mesh.rank() != 0:
        return
    config = {"stage": stage, "config_file": args.config_file, "amp": bool(args.amp),
              "devices": mesh.world()}
    section = getattr(args, f"{stage}_train", None)
    if isinstance(section, dict):
        config.update({f"{stage}_{k}": v for k, v in section.items()})
    run_id = log_training_run(tracker, config, final_metrics,
                              checkpoint_dir=getattr(args, "model_dir", None), run_name=stage)
    log.info("tracked run %s (%s)", run_id, stage)


def pin_fp32_precision() -> None:
    """fp32 matmuls and convolutions in full fp32: both ``allow_tf32``
    flags False (PyTorch's default takes TF32 for fp32 convolutions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32_flags(enabled: bool):
    """Both ``allow_tf32`` flags set to ``enabled`` inside the block, and
    back to what they were on leaving it."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``, raising when a CUDA device is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def model_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.amp else torch.float32


def env_seed(args, default: int = 42) -> int:
    """The environment seed, honouring an explicit 0."""
    seed = getattr(args, "seed", None)
    return default if seed is None or seed == "" else int(seed)


def save_two_stage(model_dir: str, ae: torch.nn.Module, unet: torch.nn.Module,
                   scale_factor: float) -> None:
    """Write the two ``best`` checkpoints :func:`load_two_stage` reads."""
    CheckpointManager(model_dir, "autoencoder").save("best", {"state_dict": ae.state_dict()})
    CheckpointManager(model_dir, "diffusion").save(
        "best", {"state_dict": unet.state_dict()}, {"scale_factor": float(scale_factor)})


def load_two_stage(args, device: torch.device, dtype: torch.dtype, use_ema: bool = False):
    """Build AE + UNet from the config on ``device`` and load both checkpoints
    (the UNet's ``ema`` role when ``use_ema``; it must exist). Returns ``(ae,
    unet, latent_shape, scale_factor)``, both models in eval mode with compute
    dtype ``dtype``; the ``scale_factor`` is the ``best`` role's."""
    u_ckpt = CheckpointManager(args.model_dir, "diffusion")
    if use_ema and not u_ckpt.exists("ema"):
        raise FileNotFoundError("no 'ema' checkpoint found; train with --ema-decay first")
    models = []
    for ckpt, role, key in ((CheckpointManager(args.model_dir, "autoencoder"), "best",
                             "autoencoder_def"),
                            (u_ckpt, "ema" if use_ema else "best", "diffusion_def")):
        state = ckpt.load(role, map_location=device)
        with torch.device(device):
            model = define_instance(args, key)
        model.load_state_dict(state["state_dict"])
        model.compute_dtype = dtype
        models.append(model.eval())
    ae, unet = models
    scale_factor = float(u_ckpt.load_meta("best").get("scale_factor", 1.0))
    latent_shape = [p // ae.downsample_factor for p in args.diffusion_train["patch_size"]]
    log.info("restored two-stage checkpoints from %s (unet role=%s, scale_factor=%.6f)",
             args.model_dir, "ema" if use_ema else "best", scale_factor)
    return ae, unet, latent_shape, scale_factor


def _distilled_checkpoint(model_dir) -> CheckpointManager:
    u_ckpt = CheckpointManager(model_dir, "diffusion")
    if not u_ckpt.exists("distilled"):
        raise FileNotFoundError("no 'distilled' checkpoint found; run ldm3d-distill first")
    return u_ckpt


def load_distilled_meta(model_dir) -> dict:
    """The ``distilled`` checkpoint's meta alone, to validate arguments
    before the weights are loaded; raises ``FileNotFoundError`` without one."""
    return _distilled_checkpoint(model_dir).load_meta("distilled")


def load_distilled(model_dir, unet: torch.nn.Module, sched_cfg: dict, device=None):
    """Load the progressively-distilled student (``cli.distill``) into
    ``unet`` and build its few-step schedule from the ``distilled`` role's
    meta (``timesteps``, ``prediction_type``). Returns ``(unet, scheduler,
    meta)``: the same module carrying the student's weights, a
    :class:`~ldm3d_torch.diffusion.GridDDIMScheduler`, and the meta, whose
    ``scale_factor`` is the latent scale the student was distilled at."""
    from ldm3d_torch.diffusion import GridDDIMScheduler

    u_ckpt = _distilled_checkpoint(model_dir)
    unet.load_state_dict(u_ckpt.load("distilled", map_location=device)["state_dict"])
    meta = u_ckpt.load_meta("distilled")
    scheduler = GridDDIMScheduler.create(
        meta["timesteps"], num_train_timesteps=sched_cfg["num_train_timesteps"],
        schedule=sched_cfg.get("schedule", "scaled_linear_beta"),
        beta_start=sched_cfg["beta_start"], beta_end=sched_cfg["beta_end"],
        prediction_type=meta.get("prediction_type", sched_cfg["prediction_type"]))
    return unet, scheduler, meta


def make_sampling_scheduler(name: str, steps: int | None, sched_cfg: dict,
                            timestep_spacing: str | None = None):
    """ddpm (ancestral; full schedule by default, strided when ``steps`` is
    given) / ddim / dpm (DPM-Solver++ 2M) / dpm3 (3M).

    ``steps=None`` takes :func:`default_sampler_steps`. ``timestep_spacing``
    overrides the config's. ``karras`` runs on ddim (as a GridDDIM over the
    karras grid) and dpm/dpm3; the ddpm sampler rejects it."""
    from ldm3d_torch.diffusion import (DDIMScheduler, DDPMScheduler, DPMSolverPPScheduler,
                                       GridDDIMScheduler, karras_timestep_grid)

    spacing = timestep_spacing or sched_cfg.get("timestep_spacing", "leading")
    common = dict(num_train_timesteps=sched_cfg["num_train_timesteps"],
                  schedule=sched_cfg.get("schedule", "scaled_linear_beta"),
                  beta_start=sched_cfg["beta_start"], beta_end=sched_cfg["beta_end"],
                  prediction_type=sched_cfg["prediction_type"])
    if steps is None:
        steps = default_sampler_steps(name, sched_cfg)
    if name in ("dpm", "dpm3"):
        return DPMSolverPPScheduler.create(num_inference_steps=steps,
                                           solver_order=3 if name == "dpm3" else 2,
                                           timestep_spacing=spacing, **common)
    if name == "ddim":
        if spacing == "karras":
            grid = karras_timestep_grid(common["num_train_timesteps"], steps, common["schedule"],
                                        common["beta_start"], common["beta_end"])
            return GridDDIMScheduler.create(grid, **common)
        return DDIMScheduler.create(num_inference_steps=steps, timestep_spacing=spacing, **common)
    if name == "ddpm":
        if spacing == "karras":
            raise ValueError("karras timestep_spacing is not available on the "
                             "ancestral ddpm sampler; use ddim, dpm, or dpm3")
        n_train = sched_cfg["num_train_timesteps"]
        return DDPMScheduler.create(num_inference_steps=None if steps == n_train else steps,
                                    timestep_spacing=spacing, **common)
    raise ValueError(f"unknown sampler {name!r}")


def default_sampler_steps(name: str, sched_cfg: dict) -> int:
    """Concrete step count ``make_sampling_scheduler(name, None, cfg)`` runs:
    the full training schedule for ddpm, else 50 capped by it."""
    n_train = sched_cfg["num_train_timesteps"]
    return n_train if name == "ddpm" else min(50, n_train)


# Decoding a sampled batch whole is the faster device program; decoding it a
# volume at a time lets each volume's readback overlap the next decode, which
# wins when the device-to-host link is slow. 1 GB/s separates the regimes.
READBACK_FAST_GBPS = 1.0


def probe_readback_gbps(device, nbytes: int = 16 << 20) -> float:
    """Device-to-host copy rate in GB/s: one warm copy of ``nbytes`` from
    ``device`` to the CPU, timed."""
    x = torch.zeros((nbytes // 4,), dtype=torch.float32, device=device)
    x.to("cpu", copy=True)  # warm: allocation and first-transfer set-up
    t0 = time.perf_counter()
    x.to("cpu", copy=True)
    return nbytes / max(time.perf_counter() - t0, 1e-9) / 1e9


def resolve_decode_chunk(value, logger=None, device="cuda") -> int:
    """A ``--decode-chunk`` value as a concrete chunk size: ints pass through
    (0 = the whole batch); ``'auto'`` probes ``device``'s readback rate and
    takes the whole batch on a fast link, chunks of 1 on a slow one."""
    if value != "auto":
        return max(0, int(value))
    gbps = probe_readback_gbps(device)
    chunk = 0 if gbps >= READBACK_FAST_GBPS else 1
    if logger is not None:
        logger.info("decode-chunk auto: readback %.2f GB/s -> %s",
                    gbps, "whole batch" if chunk == 0 else "chunk 1")
    return chunk
