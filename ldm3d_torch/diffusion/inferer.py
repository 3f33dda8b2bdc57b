"""Latent diffusion inferer: training-step noising, the reverse loop and the
VAE decode.

Counterpart of ``ldm3d_tpu/diffusion/inferer.py``. The JAX package compiles
the reverse loop as one ``lax.scan``; here it is a Python loop over the
scheduler's timesteps, one UNet call per step. A sampler that adds noise
(DDPM, DDIM with eta > 0) draws it per step from the caller's ``generator``,
or takes the caller's list of per-step noises. A multistep sampler
(DPM-Solver++) carries the last two x0 predictions from step to step.

Conditioning: ``condition=None`` samples unconditionally; a
``(B, d, h, w, C_cond)`` condition is channel-concatenated every step
("concat" mode). Classifier-free guidance runs the conditional and
unconditional branches (zero null condition) as one 2B-batch UNet call.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

__all__ = ["noise_prediction_inputs", "training_targets", "guided_model_pred",
           "sample_latents", "sample"]

UNetApply = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def noise_prediction_inputs(scheduler, latents: torch.Tensor, noise: torch.Tensor,
                            timesteps: torch.Tensor,
                            condition: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The UNet input of a training step: noisy (scaled) latents, with the
    condition channel-concatenated."""
    noisy = scheduler.add_noise(latents, noise, timesteps)
    if condition is not None:
        noisy = torch.cat([noisy, condition.to(noisy.dtype)], dim=-1)
    return noisy


def training_targets(scheduler, latents: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
    """Regression target per ``scheduler.prediction_type``."""
    if scheduler.prediction_type == "epsilon":
        return noise
    if scheduler.prediction_type == "sample":
        return latents
    if scheduler.prediction_type == "v_prediction":
        return scheduler.velocity(latents, noise, timesteps)
    raise ValueError(scheduler.prediction_type)


def guided_model_pred(unet_apply: UNetApply, x: torch.Tensor, t_b: torch.Tensor,
                      condition: Optional[torch.Tensor], guidance_scale: float = 1.0) -> torch.Tensor:
    """Concat-conditioned model prediction with optional batched CFG:
    ``eps_u + w * (eps_c - eps_u)`` with a zero null condition."""
    if condition is None:
        return unet_apply(x, t_b)
    cond_in = torch.cat([x, condition.to(x.dtype)], dim=-1)
    if guidance_scale == 1.0:
        return unet_apply(cond_in, t_b)
    b = x.shape[0]
    uncond_in = torch.cat([x, torch.zeros_like(condition, dtype=x.dtype)], dim=-1)
    both = unet_apply(torch.cat([cond_in, uncond_in], dim=0), torch.cat([t_b, t_b], dim=0))
    pred, pred_u = both[:b], both[b:]
    return pred_u + guidance_scale * (pred - pred_u)


@torch.no_grad()
def sample_latents(unet_apply: UNetApply, scheduler, noise: torch.Tensor,
                   condition: Optional[torch.Tensor] = None,
                   guidance_scale: float = 1.0,
                   generator: Optional[torch.Generator] = None,
                   step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Run the reverse loop in latent space from ``noise`` ``(B, d, h, w, C)``.

    ``step_noises``, when given, holds one standard-normal tensor of
    ``noise``'s shape per step, used in place of draws from ``generator``."""
    timesteps = scheduler.timesteps
    if step_noises is not None and len(step_noises) != len(timesteps):
        raise ValueError(f"{len(step_noises)} step noises for {len(timesteps)} steps")
    x = noise

    def model_pred(x, t):
        t_b = torch.full((noise.shape[0],), t, dtype=torch.int32, device=noise.device)
        return guided_model_pred(unet_apply, x, t_b, condition, guidance_scale)

    if getattr(scheduler, "multistep", False):
        # the zero inits never contribute: c2[0] = c3[0] = c3[1] = 0
        x0_prev, x0_prev2 = torch.zeros_like(noise), torch.zeros_like(noise)
        for i, t in enumerate(timesteps):
            x, x0 = scheduler.step_multistep(model_pred(x, t), i, t, x, x0_prev, x0_prev2)
            x0_prev, x0_prev2 = x0, x0_prev
        return x
    for i, t in enumerate(timesteps):
        pred = model_pred(x, t)
        if step_noises is not None:
            x = scheduler.step_with_noise(pred, t, x, step_noises[i].to(x.device))
        else:
            x = scheduler.step(pred, t, x, generator)
    return x


@torch.no_grad()
def sample(unet_apply: UNetApply, decode_apply: Callable[[torch.Tensor], torch.Tensor],
           scheduler, noise: torch.Tensor, condition: Optional[torch.Tensor] = None,
           scale_factor: float = 1.0, guidance_scale: float = 1.0,
           generator: Optional[torch.Generator] = None,
           step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Reverse loop, then divide by ``scale_factor`` and decode."""
    latents = sample_latents(unet_apply, scheduler, noise, condition, guidance_scale, generator,
                             step_noises)
    return decode_apply(latents / torch.tensor(scale_factor, dtype=latents.dtype))
