"""Learning-rate schedules as functions of the optimizer's update count.

The port of ``ldm3d_tpu/training/lr_schedules.py``, which builds optax
schedules over steps (epoch-granular via ``steps_per_epoch``):

* ``warmup_cosine``: linear 0.1 -> 1.0 of the base over 5 epochs, then
  cosine to 1e-6;
* ``cosine``: cosine to 1e-6 over ``max_epochs``;
* ``multistep``: x0.1 at epochs {100, 1000} (stage 2);
* ``constant``.

Each returns ``lr(count)`` equal to the optax schedule at ``count``, where
``count`` is the number of updates applied before this one: optax's Adam
evaluates its schedule at its own count before incrementing it, so the
first update uses ``lr(0)``. ``TrainState`` sets the optimizer's learning
rate from it before every update (no ``LambdaLR``, whose ``step()`` after the
update would shift the schedule by one).
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["build_lr_schedule", "scale_lr_for_world"]

Schedule = Callable[[int], float]


def scale_lr_for_world(lr: float, world_size: int) -> float:
    """``lr * sqrt(world) * 0.5`` above one replica, as the reference does
    (``train_autoencoder.py:246-261``; ``ldm3d_tpu/training/lr_schedules.py:22``).
    Only the stage-1 trainer calls it, as in JAX; stage 2 and distillation
    take the configured LR at any world size."""
    if world_size > 1:
        return lr * (world_size ** 0.5) * 0.5
    return lr


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax ``cosine_decay_schedule``."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def lr(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha)

    return lr


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule`` (constant ``init`` when ``steps <= 0``)."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def build_lr_schedule(name: str | None, base_lr: float, max_epochs: int, steps_per_epoch: int,
                      warmup_epochs: int = 5, eta_min: float = 1e-6,
                      milestones: tuple[int, ...] = (100, 1000), gamma: float = 0.1) -> Schedule:
    spe = max(1, steps_per_epoch)
    if name in (None, "", "constant"):
        return lambda count: base_lr
    if name == "cosine":
        return _cosine(base_lr, max(1, max_epochs * spe), eta_min / base_lr)
    if name == "warmup_cosine":
        boundary = warmup_epochs * spe
        warm = _linear(0.1 * base_lr, base_lr, boundary)
        cos = _cosine(base_lr, max(1, (max_epochs - warmup_epochs) * spe), eta_min / base_lr)
        return lambda count: warm(count) if count < boundary else cos(count - boundary)
    if name == "multistep":
        # optax piecewise_constant: the scale applies from the boundary on (count >= b)
        boundaries = sorted(m * spe for m in milestones)
        return lambda count: base_lr * gamma ** sum(count >= b for b in boundaries)
    raise ValueError(f"unknown lr schedule {name!r}")
