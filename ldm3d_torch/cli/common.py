"""Shared CLI plumbing of the port.

The subset of ``ldm3d_tpu/cli/common.py`` that sampling, serving and
training need: the parser (every flag of the JAX ``build_parser``, plus
``--device``) with :func:`reject_unported` for the flags whose paths are
not ported, config merging, the compute dtype, the environment seed, the
device rule, the two-stage checkpoints (``best``, or the UNet's ``ema``), the
sampler and grid-spacing registries with ``make_sampling_scheduler``, and the
decode-chunk choice.

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
diffusion checkpoint's meta. The training CLI writes them; reading the JAX
package's orbax checkpoints is not ported yet (ROADMAP.md queue A,
'Checkpoints').
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time

import torch

from ldm3d_torch.ckpt.manager import CheckpointManager
from ldm3d_torch.configs import define_instance, preset_path
from ldm3d_torch.utils import merge_configs_onto_args

__all__ = ["SAMPLERS", "TIMESTEP_SPACINGS", "UNPORTED", "build_parser", "reject_unported",
           "setup", "resolve_device", "pin_fp32_precision", "tf32_flags",
           "model_dtype", "env_seed", "save_two_stage", "load_two_stage",
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
                   help="number of cards: 0 or 1 run on the one card; more are not ported")
    p.add_argument("--amp", action="store_true", help="bf16 compute (parameters stay fp32)")
    p.add_argument("--compile", action="store_true",
                   help="accepted for reference parity; the port runs eager PyTorch and its own "
                        "CUDA kernels, with no torch.compile")
    p.add_argument("--profile", action="store_true", help="not ported (torch.profiler window)")
    p.add_argument("--no-images", action="store_true",
                   help="no slice images and no periodic sample for TensorBoard (training)")
    p.add_argument("--max-epochs", type=int, default=None,
                   help="override config max_epochs (training)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="use generated synthetic pairs when no NPZ dirs are set")
    p.add_argument("--track", action="store_true", help="not ported (experiment tracker)")
    p.add_argument("--experiment", default="ldm3d-tpu",
                   help="experiment name, read only by --track")
    p.add_argument("--debug-nans", action="store_true", help="not ported")
    p.add_argument("--grad-accum", type=int, default=1, help="not ported (must be 1)")
    p.add_argument("--remat", nargs="?", const="full", default=None,
                   choices=["full", "convs"], help="not ported")
    p.add_argument("--spatial", type=int, default=1, help="not ported (must be 1)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an EMA of the UNet params (e.g. 0.9999), saved as 'ema' (training)")
    p.add_argument("--multihost", action="store_true", help="not ported")
    p.add_argument("--tensor", type=int, default=1, help="not ported (must be 1)")
    p.add_argument("--zero", action="store_true", help="not ported")
    p.add_argument("--fsdp", action="store_true", help="not ported")
    p.add_argument("--pipeline", type=int, default=1, help="not ported (must be 1)")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="not ported (must be 0)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass cpu to run on the CPU)")
    return p


# flags of the JAX parser whose paths are not ported: (attribute, the values
# the port runs, ROADMAP.md queue A item); any other value raises
_PARALLEL = "'Parallelism'"
_PIPELINE = "'UNet mid_depth stack, then pipeline parallelism'"
_FOLLOW_UPS = "'Stage-2 training follow-ups'"
UNPORTED = (
    ("gpus", (0, 1), _PARALLEL),
    ("multihost", (False,), _PARALLEL),
    ("spatial", (1,), _PARALLEL),
    ("tensor", (1,), _PARALLEL),
    ("fsdp", (False,), _PARALLEL),
    ("zero", (False,), _PARALLEL),
    ("pipeline", (1,), _PIPELINE),
    ("pipeline_microbatches", (0,), _PIPELINE),
    ("remat", (None,), _FOLLOW_UPS),
    ("grad_accum", (1,), _FOLLOW_UPS),
    ("profile", (False,), _FOLLOW_UPS),
    ("track", (False,), _FOLLOW_UPS),
    ("debug_nans", (False,), _FOLLOW_UPS),
)


def reject_unported(args) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for the first
    flag set to a value whose path is not ported."""
    for attr, ported, item in UNPORTED:
        value = getattr(args, attr)
        if value not in ported:
            flag = "--" + attr.replace("_", "-")
            raise NotImplementedError(f"{flag} {value} is not ported yet: ROADMAP.md queue A, "
                                      f"{item}")


def setup(args) -> tuple:
    """Merge the config files onto ``args``, pin the fp32 precision and
    resolve the device."""
    logging.basicConfig(
        stream=sys.stdout, level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d][%(levelname)5s](%(name)s) - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    merge_configs_onto_args(args, args.environment_file, args.config_file)
    pin_fp32_precision()
    return args, resolve_device(args.device)


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
