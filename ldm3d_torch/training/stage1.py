"""Stage-1 VAE-GAN training: the generator and discriminator steps.

The port of ``ldm3d_tpu/training/stage1.py`` (its unsharded steps):

* generator loss = recon (L1 or L2) + kl_weight * KL + perceptual_weight *
  2.5D LPIPS, plus adv_weight * LSGAN(G) once the adversarial warm-up is
  over (``adv_active``);
* discriminator loss = adv_weight * 0.5 * (LSGAN fake + real) on the
  detached reconstruction of the same step, taken before the generator's
  update; the ``d_loss`` metric is the loss without the weight;
* AdamW (b1 0.5, b2 0.9, eps 1e-8, weight decay 1e-5) behind a global-norm
  clip of 0.5, for both;
* inputs clamped to [0, 1]; validation = recon + perceptual_weight *
  perceptual on the [0, 1]-clamped reconstruction.

Order of a step, as the JAX step: the generator's loss and gradients with
the discriminator's parameters as they are (the discriminator collects no
gradient from it); the generator's update (``g_grad_norm`` is the norm
before the clip); then, when adversarial, the discriminator's loss on the
reconstruction computed above and its update.

Randomness. A step's draws are a :class:`Stage1Draws`: the posterior
epsilon and the three axes' LPIPS slice indices. A step takes them as an
argument, or draws them from the caller's ``torch.Generator`` (the global
batch's under data parallelism, this rank's rows kept). The depth-sharded
steps of the JAX package are not ported (ROADMAP.md queue A,
'Parallelism').
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from ldm3d_torch.losses import (
    kl_loss,
    l1_loss,
    l2_loss,
    lsgan_discriminator_loss,
    lsgan_generator_loss,
)
from ldm3d_torch.nn.lpips import draw_slices, perceptual_loss_25d
from ldm3d_torch.training.state import ClippedAdam, TrainState

__all__ = [
    "Stage1Config",
    "Stage1Draws",
    "draw_stage1",
    "make_optimizer",
    "make_stage1_train_step",
    "make_stage1_eval_step",
]


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    recon_loss: str = "l1"
    kl_weight: float = 1e-9
    perceptual_weight: float = 1e-4
    adv_weight: float = 0.01
    grad_clip: float = 0.5
    warmup_epochs: int = 5  # adversarial losses start after this epoch
    fake_3d_ratio: float = 0.2
    clamp_inputs: bool = True


@dataclasses.dataclass
class Stage1Draws:
    """The random inputs of one step: ``eps``, fp32 standard normals of the
    latent's NDHWC shape; ``slices``, the per-axis slice indices of the 2.5D
    perceptual loss (None without it)."""

    eps: torch.Tensor
    slices: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None

    def to(self, device) -> "Stage1Draws":
        return Stage1Draws(self.eps.to(device),
                           None if self.slices is None else tuple(s.to(device)
                                                                  for s in self.slices))


def draw_stage1(generator: torch.Generator, latent_shape, volume_shape, cfg: Stage1Config,
                device, perceptual: bool = True, dp=None) -> Stage1Draws:
    """A step's draws from ``generator`` (on its device, then moved to
    ``device``): the posterior epsilon, then with ``perceptual`` the slice
    indices of each axis (:func:`~ldm3d_torch.nn.lpips.draw_slices`). With
    ``dp`` the epsilon is drawn for the global batch and this rank's rows
    kept; the slice indices are the whole batch's, on every rank."""
    shape = tuple(latent_shape)
    if dp is not None:
        shape = (dp.global_rows(shape[0]), *shape[1:])
    eps = torch.randn(shape, generator=generator, device=generator.device)
    if dp is not None:
        eps = dp.shard(eps)
    slices = draw_slices(generator, volume_shape, cfg.fake_3d_ratio) if perceptual else None
    return Stage1Draws(eps, slices).to(device)


def _accum_schedule(lr_schedule, grad_accum: int):
    """The schedule re-indexed for gradient accumulation: inside an
    accumulating optimizer the count advances once per emitted update, so
    ``lr_schedule(count * grad_accum)`` keeps the schedule's micro-step
    indexing."""
    if grad_accum <= 1 or not callable(lr_schedule):
        return lr_schedule
    return lambda count: lr_schedule(count * grad_accum)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr_schedule: Callable[[int], float],
                   grad_clip: float = 0.5, weight_decay: float = 1e-5,
                   grad_accum: int = 1, dp=None) -> ClippedAdam:
    """The reference's stage-1 optimizer: global-norm clip, then AdamW with
    b1 0.5, b2 0.9, eps 1e-8 at ``lr_schedule(count)``. ``grad_accum > 1``
    accumulates the mean gradient over that many micro-steps before each
    update (``optax.MultiSteps``), at the schedule re-indexed by
    :func:`_accum_schedule`. ``dp`` averages the gradients over the
    data-parallel ranks."""
    return ClippedAdam(params, _accum_schedule(lr_schedule, grad_accum), grad_clip,
                       betas=(0.5, 0.9), eps=1e-8, weight_decay=weight_decay,
                       grad_accum=grad_accum, dp=dp)


def _recon_fn(name: str) -> Callable:
    return l2_loss if name == "l2" else l1_loss


def _latent_shape(ae, images: torch.Tensor) -> tuple:
    f = ae.downsample_factor
    return (images.shape[0], *[s // f for s in images.shape[1:4]], ae.latent_channels)


def _draws(ae, images, generator, draws, cfg, perceptual, dp) -> Stage1Draws:
    if draws is not None:
        return draws
    return draw_stage1(generator, _latent_shape(ae, images), images.shape, cfg, images.device,
                       perceptual, dp)


def make_stage1_train_step(ae, disc, lpips, cfg: Stage1Config, dp=None):
    """The (G, D) train step. ``lpips``: an LPIPS module with frozen
    parameters, or None to drop the perceptual term.

    Returns ``train_step(g_state, d_state, images, adv_active, generator=None,
    draws=None) -> metrics``: ``images`` an NDHWC batch on the models'
    device; both updates are applied to the states in place; ``metrics``
    holds device scalars ``recon_loss``, ``kl_loss``, ``perceptual_loss``,
    ``adv_loss``, ``g_loss``, ``g_grad_norm``, ``d_loss``. With ``dp``,
    ``images`` is this rank's share of the global batch (see
    :func:`draw_stage1`); the states' optimizers average the gradients.

    The generator's loss reaches its parameters through ``backward()`` with
    the discriminator's parameters frozen for that pass (FSDP reduces only
    what ``backward()`` leaves in ``.grad``), so the discriminator's
    gradients come from its own loss alone."""
    recon_loss_fn = _recon_fn(cfg.recon_loss)
    perceptual = lpips is not None and bool(cfg.perceptual_weight)

    def train_step(g_state: TrainState, d_state: TrainState, images: torch.Tensor,
                   adv_active: bool = False, generator: Optional[torch.Generator] = None,
                   draws: Optional[Stage1Draws] = None) -> dict:
        if cfg.clamp_inputs:
            images = torch.clamp(images, 0.0, 1.0)
        draws = _draws(ae, images, generator, draws, cfg, perceptual, dp)
        zero = torch.zeros((), dtype=torch.float32, device=images.device)

        recon, z_mu, z_sigma = ae(images, draws.eps)
        rl = recon_loss_fn(recon, images)
        kl = kl_loss(z_mu, z_sigma)
        pl = perceptual_loss_25d(lpips, recon, images, draws.slices) if perceptual else zero
        loss = rl + cfg.kl_weight * kl + cfg.perceptual_weight * pl
        adv = zero
        d_params = [p for p in disc.parameters() if p.requires_grad]
        g_state.optimizer.zero_grad()
        try:
            for p in d_params:
                p.requires_grad_(False)
            if adv_active:
                adv = lsgan_generator_loss(disc(recon)[-1])
                loss = loss + cfg.adv_weight * adv
            loss.backward()
        finally:
            for p in d_params:
                p.requires_grad_(True)
        metrics = {"recon_loss": rl.detach(), "kl_loss": kl.detach(),
                   "perceptual_loss": pl.detach(), "adv_loss": adv.detach(),
                   "g_loss": loss.detach(), "g_grad_norm": g_state.apply_gradients()}
        d_raw = zero
        if adv_active:
            d_raw = lsgan_discriminator_loss(disc(recon.detach())[-1], disc(images)[-1])
            d_state.optimizer.zero_grad()
            (cfg.adv_weight * d_raw).backward()
            d_state.apply_gradients()
        metrics["d_loss"] = d_raw.detach()
        return metrics

    return train_step


def make_stage1_eval_step(ae, lpips, cfg: Stage1Config, dp=None):
    """Validation on a batch: recon + perceptual on the [0, 1]-clamped
    reconstruction. Returns ``eval_step(images, generator=None, draws=None)
    -> (metrics, recon)`` with device scalars ``val_recon_loss``,
    ``val_l_loss``, ``val_perceptual_loss``, ``val_kl_loss``."""
    recon_loss_fn = _recon_fn(cfg.recon_loss)
    perceptual = lpips is not None and bool(cfg.perceptual_weight)

    @torch.no_grad()
    def eval_step(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                  draws: Optional[Stage1Draws] = None):
        images = torch.clamp(images, 0.0, 1.0)
        draws = _draws(ae, images, generator, draws, cfg, perceptual, dp)
        recon, z_mu, z_sigma = ae(images, draws.eps)
        recon = torch.clamp(recon, 0.0, 1.0)
        rl = recon_loss_fn(recon, images)
        pl = (perceptual_loss_25d(lpips, recon, images, draws.slices) if perceptual
              else torch.zeros((), dtype=torch.float32, device=images.device))
        return {"val_recon_loss": rl + cfg.perceptual_weight * pl, "val_l_loss": rl,
                "val_perceptual_loss": pl, "val_kl_loss": kl_loss(z_mu, z_sigma)}, recon

    return eval_step
