"""Stage-1 and stage-2 losses: the port's copy of ``ldm3d_tpu/losses/losses.py``.

Every loss accumulates in fp32 whatever its inputs' dtype:

* L1/L2 reconstruction, torch ``L1Loss``/``MSELoss`` parity;
* KL of the posterior against N(0, I): per-sample sums over the latent
  dims, mean over the batch, sigma floored at 1e-8, with the reference's
  [0, 1000] clamp as an option;
* the summed variants (``*_sum``), elementwise the same formulas;
* LSGAN patch-adversarial losses for the generator and the discriminator.
"""

from __future__ import annotations

import torch

__all__ = [
    "l1_loss",
    "l2_loss",
    "kl_loss",
    "kl_loss_sum",
    "l1_loss_sum",
    "l2_loss_sum",
    "lsgan_generator_loss",
    "lsgan_discriminator_loss",
]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    diff = pred.float() - target.float()
    return torch.mean(diff * diff)


def _kl_terms(z_mu: torch.Tensor, z_sigma: torch.Tensor) -> torch.Tensor:
    mu = z_mu.float()
    sigma = torch.clamp(z_sigma.float(), min=1e-8)
    return mu * mu + sigma * sigma - torch.log(sigma * sigma + 1e-8) - 1.0


def kl_loss(z_mu: torch.Tensor, z_sigma: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)): the mean over the batch of per-sample sums;
    ``clamp=True`` clamps the result to [0, 1000] as the reference does."""
    per_sample = 0.5 * torch.sum(_kl_terms(z_mu, z_sigma), dim=tuple(range(1, z_mu.dim())))
    loss = torch.mean(per_sample)
    if clamp:
        loss = torch.clamp(loss, 0.0, 1000.0)
    return loss


def kl_loss_sum(z_mu: torch.Tensor, z_sigma: torch.Tensor) -> torch.Tensor:
    """The KL summed over every element, elementwise :func:`kl_loss`'s formula."""
    return 0.5 * torch.sum(_kl_terms(z_mu, z_sigma))


def l1_loss_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(a.float() - b.float()))


def l2_loss_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff = a.float() - b.float()
    return torch.sum(diff * diff)


def _lsq(logits: torch.Tensor, target: float) -> torch.Tensor:
    diff = logits.float() - target
    return torch.mean(diff * diff)


def lsgan_generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """The generator wants its fakes judged real: mean (D(G(x)) - 1)^2."""
    return _lsq(logits_fake, 1.0)


def lsgan_discriminator_loss(logits_fake: torch.Tensor,
                             logits_real: torch.Tensor) -> torch.Tensor:
    """0.5 * [mean D(fake)^2 + mean (D(real) - 1)^2]."""
    return 0.5 * (_lsq(logits_fake, 0.0) + _lsq(logits_real, 1.0))
