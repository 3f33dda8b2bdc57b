"""Latent diffusion sampling: the reverse loop and the VAE decode.

Counterpart of ``ldm3d_tpu/diffusion/inferer.py`` (sampling half). The JAX
package compiles the reverse loop as one ``lax.scan``; here it is a Python
loop over the scheduler's timesteps, one UNet call per step.

Conditioning: ``condition=None`` samples unconditionally; a
``(B, d, h, w, C_cond)`` condition is channel-concatenated every step
("concat" mode). Classifier-free guidance runs the conditional and
unconditional branches (zero null condition) as one 2B-batch UNet call.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["guided_model_pred", "sample_latents", "sample"]

UNetApply = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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
                   guidance_scale: float = 1.0) -> torch.Tensor:
    """Run the reverse loop in latent space from ``noise`` ``(B, d, h, w, C)``."""
    x = noise
    for t in scheduler.timesteps:
        t_b = torch.full((noise.shape[0],), t, dtype=torch.int32, device=noise.device)
        x = scheduler.step(guided_model_pred(unet_apply, x, t_b, condition, guidance_scale), t, x)
    return x


@torch.no_grad()
def sample(unet_apply: UNetApply, decode_apply: Callable[[torch.Tensor], torch.Tensor],
           scheduler, noise: torch.Tensor, condition: Optional[torch.Tensor] = None,
           scale_factor: float = 1.0, guidance_scale: float = 1.0) -> torch.Tensor:
    """Reverse loop, then divide by ``scale_factor`` and decode."""
    latents = sample_latents(unet_apply, scheduler, noise, condition, guidance_scale)
    return decode_apply(latents / torch.tensor(scale_factor, dtype=latents.dtype))
