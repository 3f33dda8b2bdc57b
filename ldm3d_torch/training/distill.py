"""Progressive distillation: halve the sampler's step count, repeatedly.

The port of ``ldm3d_tpu/training/distill.py`` (Salimans & Ho 2022): a
student, initialised from the teacher, learns to match two deterministic DDIM
jumps of the teacher on a grid with one jump on a grid half as fine. With
alpha = sqrt(abar) and sigma = sqrt(1 - abar), the teacher runs
t -> mid -> end and the x0 a one-step student must predict to land on the
teacher's z_end is

    x0_target = (z_end - (sigma_end / sigma_t) x_t)
                / (alpha_end - (sigma_end / sigma_t) alpha_t)

The loss is the truncated-SNR-weighted x0 MSE, w = max(abar / (1 - abar),
snr_floor), averaged over every element. The grids come from
:func:`ldm3d_torch.diffusion.distillation_grid`, and the distilled student
samples through :class:`ldm3d_torch.diffusion.GridDDIMScheduler`.

Teacher and student are two modules of one architecture: the teacher is
frozen (its forwards run without gradients), the student is the
:class:`TrainState`'s model, updated in place. The x0 and epsilon of a
prediction come from :func:`ldm3d_torch.diffusion.pred_x0_and_eps`, the
division form of the JAX step, at one alpha_bar a sample.

Randomness: a step's draws are a :class:`DistillDraws` (the label's and the
image's posterior epsilon, the noise, the student step index of each sample),
given by the caller or drawn from its ``torch.Generator`` in the order of the
JAX step's ``jax.random.split(rng, 4)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ldm3d_torch.diffusion.inferer import guided_model_pred
from ldm3d_torch.diffusion.schedulers import distillation_grid, pred_x0_and_eps
from ldm3d_torch.training.state import TrainState

__all__ = ["DistillConfig", "DistillDraws", "draw_distill", "make_distillation_step",
           "student_timesteps"]


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    teacher_steps: int  # N: the teacher's DDIM grid; the student learns N // 2
    conditional: bool = True
    clamp_inputs: bool = True
    # truncated-SNR loss weight floor: w = max(SNR(t), snr_floor)
    snr_floor: float = 1.0
    # the parameterisation the student regresses (None = the teacher's)
    student_prediction_type: Optional[str] = None
    # guidance distillation: the teacher's predictions run classifier-free
    # guidance at this weight, so the student bakes it in (first round only)
    guidance_scale: float = 1.0

    def __post_init__(self):
        if self.teacher_steps < 2 or self.teacher_steps % 2:
            raise ValueError(f"teacher_steps must be even and >= 2, got {self.teacher_steps}")
        if self.guidance_scale != 1.0 and not self.conditional:
            raise ValueError("guidance distillation needs a conditional model")


def student_timesteps(num_train_timesteps: int, teacher_steps: int) -> np.ndarray:
    """The distilled student's visited timesteps (its GridDDIM schedule): the
    even entries of the teacher grid, ``distillation_grid(T, N // 2)[:-1]``."""
    return distillation_grid(num_train_timesteps, teacher_steps // 2)[:-1]


@dataclasses.dataclass
class DistillDraws:
    """The random inputs of one step: fp32 standard normals of the latent's
    NDHWC shape (``eps_image`` None when unconditional) and ``j``, the (B,)
    student step index of each sample in ``[0, teacher_steps // 2)``."""

    eps_label: torch.Tensor
    eps_image: Optional[torch.Tensor]
    noise: torch.Tensor
    j: torch.Tensor

    def to(self, device) -> "DistillDraws":
        return DistillDraws(*(None if t is None else t.to(device)
                              for t in dataclasses.astuple(self)))

    def shard(self, dp) -> "DistillDraws":
        """This rank's rows of a global batch's draws."""
        return DistillDraws(*(dp.shard(t) for t in dataclasses.astuple(self)))


def draw_distill(generator: torch.Generator, latent_shape, cfg: DistillConfig,
                 device, dp=None) -> DistillDraws:
    """A step's draws from ``generator`` (on its device, then moved to
    ``device``): label epsilon, image epsilon (conditional), noise, j. With
    ``dp`` the global batch's draws are made and this rank's rows kept."""
    if dp is not None:
        global_shape = (dp.global_rows(latent_shape[0]), *latent_shape[1:])
        return draw_distill(generator, global_shape, cfg, device).shard(dp)
    g = generator.device

    def normal():
        return torch.randn(tuple(latent_shape), generator=generator, device=g)

    eps_label = normal()
    eps_image = normal() if cfg.conditional else None
    noise = normal()
    j = torch.randint(0, cfg.teacher_steps // 2, (latent_shape[0],), generator=generator,
                      device=g)
    return DistillDraws(eps_label, eps_image, noise, j).to(device)


def _gather(table: torch.Tensor, j: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-sample entries of ``table`` at ``j``, shaped to broadcast against
    the (B, ...) volume ``like``."""
    v = table.to(j.device)[j]
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def make_distillation_step(unet, ae, scheduler, cfg: DistillConfig, dp=None):
    """Build the one-halving distillation step.

    ``unet`` gives the compute dtype of both UNet roles (the teacher's and
    the student's, one architecture); ``ae`` is the frozen VAE; ``scheduler``
    the teacher's :class:`~ldm3d_torch.diffusion.DDPMScheduler` (its
    ``prediction_type``, alpha_bar table and clip). Returns ``step(
    student_state, teacher, batch, scale_factor, generator=None, draws=None)
    -> {"distill_loss", "grad_norm"}`` (device tensors) with ``batch =
    {"image": low, "label": high}`` NDHWC tensors on the models' device; the
    update is applied to ``student_state`` in place. The order of work is the
    JAX step's: clamp, both encodes, the tables at j, x_t, two guided
    teacher DDIM jumps with the scheduler's clip, the implied one-step x0
    target, the student's loss, backward, clip and update."""
    teacher_pt = scheduler.prediction_type
    student_pt = cfg.student_prediction_type or teacher_pt
    abar = scheduler.alphas_cumprod.float()
    grid = torch.from_numpy(distillation_grid(scheduler.num_train_timesteps,
                                              cfg.teacher_steps).astype(np.int64))
    m = cfg.teacher_steps // 2
    # per student step j: the visited t, the teacher's midpoint, and the three
    # states' alpha_bar (the last jump's end is the terminal state, abar 1)
    t_vis, t_mid = grid[0:2 * m:2], grid[1:2 * m:2]
    a_t_tab, a_mid_tab = abar[t_vis], abar[t_mid]
    a_end_tab = torch.cat([abar[grid[2:2 * m:2]], torch.ones((1,), dtype=torch.float32)])

    def clip(x0):
        if scheduler.clip_sample:
            return torch.clamp(x0, -scheduler.clip_range, scheduler.clip_range)
        return x0

    @torch.no_grad()
    def targets(teacher, batch, scale_factor, draws: DistillDraws):
        """x_t, t, a_t, the condition, the x0 target and the loss weight."""
        images, labels = batch["image"], batch["label"]
        if cfg.clamp_inputs:
            images, labels = torch.clamp(images, 0.0, 1.0), torch.clamp(labels, 0.0, 1.0)
        z0 = ae.encode_stage_2_inputs(labels, draws.eps_label).float() * scale_factor
        condition = ae.encode_stage_2_inputs(images, draws.eps_image) if cfg.conditional else None
        j = draws.j.long()
        t = t_vis.to(j.device)[j]
        a_t, a_mid, a_end = (_gather(tab, j, z0) for tab in (a_t_tab, a_mid_tab, a_end_tab))
        x_t = torch.sqrt(a_t) * z0 + torch.sqrt(1.0 - a_t) * draws.noise.float()
        dt = unet.compute_dtype

        def teacher_pred(z, tt):
            return guided_model_pred(teacher, z.to(dt), tt, condition,
                                     cfg.guidance_scale).float()

        # the teacher: two DDIM jumps t -> mid -> end on the fine grid
        x0_1, eps_1 = pred_x0_and_eps(teacher_pred(x_t, t), x_t, a_t, teacher_pt)
        z_mid = torch.sqrt(a_mid) * clip(x0_1) + torch.sqrt(1.0 - a_mid) * eps_1
        x0_2, eps_2 = pred_x0_and_eps(teacher_pred(z_mid, t_mid.to(j.device)[j]), z_mid, a_mid,
                                      teacher_pt)
        z_end = torch.sqrt(a_end) * clip(x0_2) + torch.sqrt(1.0 - a_end) * eps_2
        # the x0 a one-step student must predict to land on z_end
        ratio = torch.sqrt((1.0 - a_end) / (1.0 - a_t))
        x0_tgt = (z_end - ratio * x_t) / (torch.sqrt(a_end) - ratio * torch.sqrt(a_t))
        w = torch.clamp(a_t / (1.0 - a_t), min=cfg.snr_floor)
        return x_t, t, a_t, condition, x0_tgt, w

    def step(student_state: TrainState, teacher, batch: dict, scale_factor, generator=None,
             draws: Optional[DistillDraws] = None) -> dict:
        if draws is None:
            labels = batch["label"]
            f = ae.downsample_factor
            shape = (labels.shape[0], *[s // f for s in labels.shape[1:4]], ae.latent_channels)
            draws = draw_distill(generator, shape, cfg, labels.device, dp=dp)
        x_t, t, a_t, condition, x0_tgt, w = targets(teacher, batch, scale_factor, draws)
        zin = x_t.to(unet.compute_dtype)
        if condition is not None:
            zin = torch.cat([zin, condition.to(zin.dtype)], dim=-1)
        pred = student_state.model(zin, t).float()
        x0_s, _ = pred_x0_and_eps(pred, x_t, a_t, student_pt)
        loss = torch.mean(w * (x0_s - x0_tgt) ** 2)
        student_state.optimizer.zero_grad()
        loss.backward()
        grad_norm = student_state.apply_gradients()
        return {"distill_loss": loss.detach(), "grad_norm": grad_norm}

    return step
