"""Shared CLI plumbing of the port.

The subset of ``ldm3d_tpu/cli/common.py`` that conditional DDIM sampling
needs: the parser (``-c -e -n --sampler --steps --batch --guidance --amp
--synthetic-data``, plus ``--device``), config merging, the compute dtype,
the environment seed, the device rule, and the two-stage checkpoints.

Device rule: entry points run on ``cuda`` unless the caller passes
``--device cpu``. Without a CUDA device and without ``--device cpu`` they
raise; they never carry on on the CPU.

Checkpoints: the ``best`` roles of :class:`ldm3d_torch.ckpt.CheckpointManager`,
``model_dir/autoencoder_best.pt`` and ``model_dir/diffusion_best.pt``, each
``{"state_dict": ..., "meta": {...}}``; the latent ``scale_factor`` is in the
diffusion checkpoint's meta. The training CLI writes them; reading the JAX
package's orbax checkpoints is not ported yet (ROADMAP.md queue A,
'Checkpoints').
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from ldm3d_torch.ckpt.manager import CheckpointManager
from ldm3d_torch.configs import define_instance, preset_path
from ldm3d_torch.utils import merge_configs_onto_args

__all__ = ["SAMPLERS", "build_parser", "setup", "resolve_device", "model_dtype", "env_seed",
           "save_two_stage", "load_two_stage", "make_sampling_scheduler"]

log = logging.getLogger("ldm3d_torch")

# the JAX package's sampler registry; only ddim is ported in this slice
SAMPLERS = ("ddpm", "ddim", "dpm", "dpm3")


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-e", "--environment-file", default=preset_path("environment.json"),
                   help="environment json file that stores environment paths")
    p.add_argument("-c", "--config-file", default=preset_path("config_train_32g.json"),
                   help="config json file that stores hyper-parameters")
    p.add_argument("--amp", action="store_true", help="bf16 compute (parameters stay fp32)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="use generated synthetic pairs when no NPZ dirs are set")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; pass cpu to run on the CPU)")
    return p


def setup(args) -> tuple:
    """Merge the config files onto ``args`` and resolve the device."""
    logging.basicConfig(
        stream=sys.stdout, level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d][%(levelname)5s](%(name)s) - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    merge_configs_onto_args(args, args.environment_file, args.config_file)
    return args, resolve_device(args.device)


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


def load_two_stage(args, device: torch.device, dtype: torch.dtype):
    """Build AE + UNet from the config on ``device`` and load both checkpoints.
    Returns ``(ae, unet, latent_shape, scale_factor)``, both models in eval mode
    with compute dtype ``dtype``."""
    models = []
    for role, key in (("autoencoder", "autoencoder_def"), ("diffusion", "diffusion_def")):
        ckpt = CheckpointManager(args.model_dir, role).load("best", map_location=device)
        with torch.device(device):
            model = define_instance(args, key)
        model.load_state_dict(ckpt["state_dict"])
        model.compute_dtype = dtype
        models.append((model.eval(), ckpt["meta"]))
    (ae, _), (unet, u_meta) = models
    scale_factor = float(u_meta.get("scale_factor", 1.0))
    latent_shape = [p // ae.downsample_factor for p in args.diffusion_train["patch_size"]]
    log.info("restored two-stage checkpoints from %s (scale_factor=%.6f)", args.model_dir,
             scale_factor)
    return ae, unet, latent_shape, scale_factor


def make_sampling_scheduler(name: str, steps: int | None, sched_cfg: dict):
    """The ``ddim`` sampler (default 50 steps, capped by the training schedule).
    Other samplers are not ported yet and raise ``NotImplementedError``."""
    from ldm3d_torch.diffusion import DDIMScheduler

    if name != "ddim":
        if name in SAMPLERS:
            raise NotImplementedError(
                f"sampler {name!r} is not ported yet: ROADMAP.md queue A, "
                f"'DDPM / DPM-Solver++ / GridDDIM samplers'")
        raise ValueError(f"unknown sampler {name!r}")
    if steps is None:
        steps = min(50, sched_cfg["num_train_timesteps"])
    return DDIMScheduler.create(
        num_train_timesteps=sched_cfg["num_train_timesteps"],
        schedule=sched_cfg.get("schedule", "scaled_linear_beta"),
        beta_start=sched_cfg["beta_start"], beta_end=sched_cfg["beta_end"],
        prediction_type=sched_cfg["prediction_type"], num_inference_steps=steps,
        timestep_spacing=sched_cfg.get("timestep_spacing", "leading"))
