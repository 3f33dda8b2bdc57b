"""Train state: model, optimizer, update count and an optional EMA copy.

The port of ``ldm3d_tpu/training/state.py``. JAX's state is one pytree
replaced on every update; here the model's parameters, the Adam moments and
the EMA tensors are updated in place (one copy of each in device memory),
and :meth:`TrainState.state_dict` gathers them for a checkpoint, so a resume
continues the schedule exactly.

:class:`ClippedAdam` is ``optax.chain(clip_by_global_norm(c), adam(lr))``:
the global-norm clip is optax's rule, ``g`` kept when ``||g|| < c`` and
``(g / ||g||) * c`` otherwise, not ``torch.nn.utils.clip_grad_norm_``, whose
``+1e-6`` in the denominator scales every clipped update differently.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

__all__ = ["ClippedAdam", "TrainState", "clip_by_global_norm_", "global_norm"]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element, fp32 (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def clip_by_global_norm_(tensors: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: keep every tensor when the
    global norm is below ``max_norm``, else ``(t / norm) * max_norm``.
    Returns the norm before clipping. No host sync: the branch is a
    ``torch.where`` on the device."""
    if norm is None:
        norm = global_norm(tensors)
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(one, max_norm))
    for t in tensors:
        t.div_(div.to(t.dtype)).mul_(mul.to(t.dtype))
    return norm


class ClippedAdam:
    """Global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8) at the
    learning rate ``lr_schedule(count)`` of the update's count."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr_schedule: Callable[[int], float],
                 grad_clip: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.adam = torch.optim.Adam(self.params, lr=lr_schedule(0), betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        """Clip the parameters' gradients and apply one Adam update; returns
        the gradients' global norm before the clip. A parameter that got no
        gradient is updated with a zero one, as optax does."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = clip_by_global_norm_(grads, self.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_schedule(count)
        self.adam.step()
        return norm

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


class TrainState:
    """``model`` + ``optimizer`` + ``step`` (updates applied) + EMA params."""

    def __init__(self, model: torch.nn.Module, optimizer: ClippedAdam, ema_decay: float = 0.0,
                 ema_every: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.step = 0
        self.ema_decay = ema_decay
        # EMA cadence in micro-steps (the JAX rule under gradient accumulation:
        # decay once per emitted update)
        self.ema_every = max(1, ema_every)
        self.ema_params = ({n: p.detach().clone() for n, p in model.named_parameters()}
                           if ema_decay > 0 else None)

    def apply_gradients(self) -> torch.Tensor:
        """Clip -> Adam -> EMA, from the gradients in the parameters' ``.grad``;
        returns the gradients' global norm."""
        norm = self.optimizer.step(self.step)
        if self.ema_params is not None and (self.step + 1) % self.ema_every == 0:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.ema_params[name].mul_(d).add_(p.detach(), alpha=1.0 - d)
        self.step += 1
        return norm

    def state_dict(self) -> dict:
        out = {"params": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
               "step": self.step}
        if self.ema_params is not None:
            out["ema_params"] = self.ema_params
        return out

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.ema_params is not None:
            if "ema_params" not in state:
                raise KeyError("the checkpoint holds no EMA params, but this run keeps an EMA")
            for name, t in state["ema_params"].items():
                self.ema_params[name].copy_(t)
