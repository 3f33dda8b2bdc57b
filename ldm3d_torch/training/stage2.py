"""Stage-2 conditional latent-diffusion training.

The port of ``ldm3d_tpu/training/stage2.py`` (unsharded steps):

* the frozen stage-1 VAE encodes the high-count "label" volume into the
  denoising target latent and the low-count "image" volume into the concat
  condition; the condition latents are concatenated unscaled, only the
  denoised latent carries ``scale_factor``;
* ``scale_factor = 1 / std(z_labels)`` (population std) from the first batch;
* epsilon-prediction MSE (optionally Min-SNR-weighted), Adam with a
  global-norm clip of 1.0;
* validation: the same noise-prediction MSE on held-out pairs.

Randomness. Every random draw of a step is in a :class:`Stage2Draws`: the
posterior epsilon of the labels and of the images, the noise, the timesteps
and the condition-dropout mask. A step takes them as an argument, or draws
them from the caller's ``torch.Generator`` in the order of the JAX step's
``jax.random.split(rng, 5)``, so a test can hand both frameworks the same
draws. Under data parallelism (``dp``) each rank draws the global batch's
draws and keeps its rows, as JAX draws for the global batch and shards.

Depth sharding (``--spatial``): :func:`make_stage2_train_step` and
:func:`make_stage2_eval_step` with a spatial group ``sg`` (JAX's
``make_stage2_train_step_spatial`` and ``make_stage2_eval_step_spatial``)
run the frozen VAE's encode and the UNet on this rank's depth slab of its
rows (the models bound to the group by
:func:`~ldm3d_torch.parallel.spatial.spatial_clone`). Their draws are the
global batch's and volume's, cut to this rank's rows and slab, so a step
computes the one-process step on the same draws. The pipelined step of the
JAX package is not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from ldm3d_torch.diffusion import inferer
from ldm3d_torch.losses import l2_loss
from ldm3d_torch.training.state import ClippedAdam, TrainState

__all__ = [
    "Stage2Config",
    "Stage2Draws",
    "draw_stage2",
    "min_snr_weights",
    "make_diffusion_optimizer",
    "compute_scale_factor",
    "make_stage2_train_step",
    "make_stage2_train_step_latents",
    "make_stage2_eval_step",
]


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    grad_clip: float = 1.0
    conditional: bool = True
    clamp_inputs: bool = True
    # per-sample probability of zeroing the condition during training, which
    # makes classifier-free guidance meaningful at sampling time
    cond_dropout: float = 0.0
    # Min-SNR-gamma loss weighting (Hang et al. 2023); 0 = uniform weighting
    min_snr_gamma: float = 0.0


@dataclasses.dataclass
class Stage2Draws:
    """The random inputs of one step. ``eps_*`` and ``noise`` are fp32
    standard normals of the latent's NDHWC shape; ``timesteps`` ``(B,)``
    integers in ``[0, num_train_timesteps)``; ``keep`` the ``(B,)`` boolean
    condition-dropout mask (None without dropout)."""

    eps_label: torch.Tensor
    eps_image: Optional[torch.Tensor]
    noise: torch.Tensor
    timesteps: torch.Tensor
    keep: Optional[torch.Tensor] = None

    def to(self, device) -> "Stage2Draws":
        return Stage2Draws(*(None if t is None else t.to(device)
                             for t in dataclasses.astuple(self)))

    def shard(self, dp) -> "Stage2Draws":
        """This rank's rows of a global batch's draws."""
        return Stage2Draws(*(dp.shard(t) for t in dataclasses.astuple(self)))

    def shard_depth(self, sg) -> "Stage2Draws":
        """This rank's depth slab of a global volume's draws (the per-sample
        timesteps and mask are the volume's)."""
        from ldm3d_torch.parallel.spatial import shard_volume

        def cut(t):
            return t if t is None or t.dim() < 5 else shard_volume(t, sg)

        return Stage2Draws(*(cut(t) for t in dataclasses.astuple(self)))


def draw_stage2(generator: torch.Generator, latent_shape, num_train_timesteps: int,
                cfg: Stage2Config, device, dropout: bool = True, dp=None,
                sg=None) -> Stage2Draws:
    """A step's draws from ``generator`` (on the generator's device, then
    moved to ``device``): label epsilon, image epsilon (conditional), noise,
    timesteps, and the dropout mask (conditional with ``cond_dropout > 0``
    and ``dropout``). With ``dp`` (a data-parallel axis), ``latent_shape``
    is this rank's: the global batch's draws are made and this rank's rows
    kept; with ``sg`` (a spatial group) it is this rank's depth slab, and
    the whole volume's draws are made and this rank's slab kept."""
    if sg is not None:
        global_shape = (latent_shape[0], latent_shape[1] * sg.size, *latent_shape[2:])
        return draw_stage2(generator, global_shape, num_train_timesteps, cfg, device, dropout,
                           dp).shard_depth(sg)
    if dp is not None:
        global_shape = (dp.global_rows(latent_shape[0]), *latent_shape[1:])
        return draw_stage2(generator, global_shape, num_train_timesteps, cfg, device,
                           dropout).shard(dp)
    g = generator.device

    def normal():
        return torch.randn(tuple(latent_shape), generator=generator, device=g)

    eps_label = normal()
    eps_image = normal() if cfg.conditional else None
    noise = normal()
    b = latent_shape[0]
    timesteps = torch.randint(0, num_train_timesteps, (b,), generator=generator, device=g)
    keep = None
    if dropout and cfg.conditional and cfg.cond_dropout > 0:
        keep = torch.rand((b,), generator=generator, device=g) < 1.0 - cfg.cond_dropout
    return Stage2Draws(eps_label, eps_image, noise, timesteps, keep).to(device)


def min_snr_weights(scheduler, timesteps: torch.Tensor, gamma: float) -> torch.Tensor:
    """Per-sample Min-SNR-gamma loss weights for the scheduler's target:
    SNR = abar / (1 - abar); epsilon min(SNR, g) / SNR, v-prediction
    min(SNR, g) / (SNR + 1), sample min(SNR, g)."""
    abar = scheduler.alphas_cumprod.to(timesteps.device)[timesteps.long()].float()
    snr = abar / torch.clamp(1.0 - abar, min=1e-12)
    clipped = torch.clamp(snr, max=gamma)
    pt = scheduler.prediction_type
    if pt == "epsilon":
        return clipped / torch.clamp(snr, min=1e-12)
    if pt == "v_prediction":
        return clipped / (snr + 1.0)
    if pt == "sample":
        return clipped
    raise ValueError(pt)


def _drop_condition(condition: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the condition of the samples whose ``keep`` is False."""
    mask = keep.reshape((condition.shape[0],) + (1,) * (condition.dim() - 1))
    return condition * mask.to(condition.dtype)


def _stage2_mse(pred, target, timesteps, scheduler, cfg: Stage2Config) -> torch.Tensor:
    """fp32 squared error, mean over everything, optionally Min-SNR-weighted
    per sample."""
    diff = (pred.float() - target.float()) ** 2
    if cfg.min_snr_gamma > 0:
        w = min_snr_weights(scheduler, timesteps, cfg.min_snr_gamma)
        diff = diff * w.reshape((timesteps.shape[0],) + (1,) * (diff.dim() - 1))
    return torch.mean(diff)


def make_diffusion_optimizer(params: Iterable[torch.nn.Parameter],
                             lr_schedule: Callable[[int], float],
                             grad_clip: float = 1.0, grad_accum: int = 1,
                             dp=None) -> ClippedAdam:
    """Adam (not AdamW: reference ``train_diffusion.py:155``) behind a
    global-norm clip of 1.0; ``grad_accum > 1`` as in
    :func:`~ldm3d_torch.training.stage1.make_optimizer`; ``dp`` averages the
    gradients over the data-parallel ranks."""
    from ldm3d_torch.training.stage1 import _accum_schedule

    return ClippedAdam(params, _accum_schedule(lr_schedule, grad_accum), grad_clip,
                       grad_accum=grad_accum, dp=dp)


@torch.no_grad()
def compute_scale_factor(ae, labels: torch.Tensor, eps: torch.Tensor, dp=None) -> torch.Tensor:
    """``1 / std(z_labels)`` over the whole batch, the population std (as
    ``jnp.std``), from the posterior sample with standard-normal ``eps``.
    With ``dp`` the batch is this rank's share and the std is the global
    batch's: the ranks all-reduce Σz, Σz² and n (fp64), so every rank gets
    the same ``scale_factor``."""
    z = ae.encode_stage_2_inputs(labels, eps).float()
    if dp is None:
        return 1.0 / torch.std(z, correction=0)
    z64 = z.double()
    sums = dp.all_reduce_sum(torch.stack([z64.sum(), (z64 * z64).sum(),
                                          torch.tensor(float(z.numel()), dtype=torch.float64,
                                                       device=z.device)]))
    mean = sums[0] / sums[2]
    var = torch.clamp(sums[1] / sums[2] - mean * mean, min=0.0)
    return (1.0 / torch.sqrt(var)).float()


def _latent_shape(ae, volumes: torch.Tensor) -> tuple:
    f = ae.downsample_factor
    return (volumes.shape[0], *[s // f for s in volumes.shape[1:4]], ae.latent_channels)


def _apply_update(state: TrainState, loss: torch.Tensor) -> dict:
    state.optimizer.zero_grad()
    loss.backward()
    grad_norm = state.apply_gradients()
    return {"diffusion_loss": loss.detach(), "grad_norm": grad_norm}


def _denoise_loss(unet, scheduler, cfg, z_labels, condition, noise, timesteps):
    model_in = inferer.noise_prediction_inputs(scheduler, z_labels, noise, timesteps, condition)
    pred = unet(model_in, timesteps)
    target = inferer.training_targets(scheduler, z_labels, noise, timesteps)
    return _stage2_mse(pred, target, timesteps, scheduler, cfg)


def _bound(unet, ae, sg):
    """The models bound to the spatial group ``sg`` (as they are without)."""
    if sg is None:
        return unet, ae
    from ldm3d_torch.parallel.spatial import spatial_clone

    return spatial_clone(unet, sg), spatial_clone(ae, sg)


def make_stage2_train_step(unet, ae, scheduler, cfg: Stage2Config, dp=None, sg=None):
    """The LDM train step with the frozen-VAE encode inside.

    Returns ``train_step(state, batch, scale_factor, generator=None,
    draws=None) -> metrics`` with ``batch = {"image": low, "label": high}``
    NDHWC tensors on the model's device; ``metrics`` holds the device tensors
    ``diffusion_loss`` and ``grad_norm``. The update is applied to
    ``state`` in place. With ``dp`` the batch is this rank's share and the
    draws are the global batch's rows of this rank (:func:`draw_stage2`);
    the state's optimizer averages the gradients over the ranks.

    With a spatial group ``sg`` (JAX ``ldm3d_tpu/training/stage2.py:210``)
    the batch is this rank's depth slab of its rows, and the encode, the
    UNet and its backward run on the slab (halo convolutions, group-summed
    GroupNorm, gathered-kv attention); ``draws``, when given, are this
    rank's rows and slab of the global draws. The loss is the slab's mean
    over ``sg.size``, so the group's sum of the gradients is the replica's
    (the optimizer, built with ``dp``, sums them over the group and averages
    them over the data axis before the clip); ``diffusion_loss`` is the
    replica's, summed over the group; ``grad_norm`` is read after the
    reduction."""
    unet, ae = _bound(unet, ae, sg)

    def train_step(state: TrainState, batch: dict, scale_factor, generator=None,
                   draws: Optional[Stage2Draws] = None) -> dict:
        images, labels = batch["image"], batch["label"]
        if cfg.clamp_inputs:
            images, labels = torch.clamp(images, 0.0, 1.0), torch.clamp(labels, 0.0, 1.0)
        if draws is None:
            draws = draw_stage2(generator, _latent_shape(ae, labels),
                                scheduler.num_train_timesteps, cfg, labels.device, dp=dp, sg=sg)
        with torch.no_grad():  # frozen VAE: gradients stop at the latents
            # an fp32 scale factor promotes the latents to fp32, as in JAX
            z_labels = ae.encode_stage_2_inputs(labels, draws.eps_label).float() * scale_factor
            condition = None
            if cfg.conditional:
                condition = ae.encode_stage_2_inputs(images, draws.eps_image)
                if draws.keep is not None:
                    condition = _drop_condition(condition, draws.keep)
        noise = draws.noise.to(z_labels.dtype)
        loss = _denoise_loss(unet, scheduler, cfg, z_labels, condition, noise, draws.timesteps)
        if sg is None:
            return _apply_update(state, loss)
        metrics = _apply_update(state, loss / sg.size)
        metrics["diffusion_loss"] = sg.all_reduce_(metrics["diffusion_loss"].clone())
        return metrics

    return train_step


def make_stage2_train_step_latents(unet, scheduler, cfg: Stage2Config, dp=None):
    """The LDM train step over precomputed posterior latents
    (:class:`ldm3d_torch.data.LatentCache`): ``z = mu + sigma * eps`` with
    fresh eps each step, as ``encode_stage_2_inputs`` does, and no VAE call.

    ``batch``: ``{"label_mu", "label_sigma"[, "image_mu", "image_sigma"]}``,
    fp32 NDHWC tensors on the model's device. Returns ``train_step(state,
    batch, scale_factor, generator=None, draws=None) -> metrics``."""

    def train_step(state: TrainState, batch: dict, scale_factor, generator=None,
                   draws: Optional[Stage2Draws] = None) -> dict:
        dt = unet.compute_dtype
        mu, sigma = batch["label_mu"], batch["label_sigma"]
        if draws is None:
            draws = draw_stage2(generator, mu.shape, scheduler.num_train_timesteps, cfg,
                                mu.device, dp=dp)
        z_labels = ((mu + sigma * draws.eps_label) * scale_factor).to(dt)
        condition = None
        if cfg.conditional:
            condition = (batch["image_mu"] + batch["image_sigma"] * draws.eps_image).to(dt)
            if draws.keep is not None:
                condition = _drop_condition(condition, draws.keep)
        noise = draws.noise.to(dt)
        loss = _denoise_loss(unet, scheduler, cfg, z_labels, condition, noise, draws.timesteps)
        return _apply_update(state, loss)

    return train_step


def make_stage2_eval_step(unet, ae, scheduler, cfg: Stage2Config, dp=None, sg=None):
    """Validation: the noise-prediction MSE on a batch, no dropout. Returns
    ``eval_step(batch, scale_factor, generator=None, draws=None) ->
    {"val_diffusion_loss": device tensor}``. With a spatial group ``sg``
    (JAX ``ldm3d_tpu/training/stage2.py:436``) the batch and ``draws`` are
    this rank's slabs, as in :func:`make_stage2_train_step`, and the loss is
    the replica's (the slabs' means summed over the group / ``sg.size``)."""
    unet, ae = _bound(unet, ae, sg)

    @torch.no_grad()
    def eval_step(batch: dict, scale_factor, generator=None,
                  draws: Optional[Stage2Draws] = None) -> dict:
        images, labels = batch["image"], batch["label"]
        if cfg.clamp_inputs:
            images, labels = torch.clamp(images, 0.0, 1.0), torch.clamp(labels, 0.0, 1.0)
        if draws is None:
            draws = draw_stage2(generator, _latent_shape(ae, labels),
                                scheduler.num_train_timesteps, cfg, labels.device,
                                dropout=False, dp=dp, sg=sg)
        z_labels = ae.encode_stage_2_inputs(labels, draws.eps_label).float() * scale_factor
        condition = (ae.encode_stage_2_inputs(images, draws.eps_image)
                     if cfg.conditional else None)
        noise = draws.noise.to(z_labels.dtype)
        model_in = inferer.noise_prediction_inputs(scheduler, z_labels, noise, draws.timesteps,
                                                   condition)
        pred = unet(model_in, draws.timesteps)
        target = inferer.training_targets(scheduler, z_labels, noise, draws.timesteps)
        loss = l2_loss(pred, target)
        if sg is not None:
            loss = sg.all_reduce_(loss / sg.size)
        return {"val_diffusion_loss": loss}

    return eval_step
