"""Train state: model, optimizer, update count and an optional EMA copy.

The port of ``ldm3d_tpu/training/state.py``. JAX's state is one pytree
replaced on every update; here the model's parameters, the Adam moments and
the EMA tensors are updated in place (one copy of each in device memory),
and :meth:`TrainState.state_dict` gathers them for a checkpoint, so a resume
continues the schedule exactly.

:class:`ClippedAdam` is ``optax.chain(clip_by_global_norm(c), adamw(lr))``,
with a weight decay of 0 (``adam``, stage 2) or not (stage 1): the
global-norm clip is optax's rule, ``g`` kept when ``||g|| < c`` and
``(g / ||g||) * c`` otherwise, not ``torch.nn.utils.clip_grad_norm_``,
whose ``+1e-6`` in the denominator scales every clipped update differently.

Gradient accumulation (``grad_accum = k > 1``) is
``optax.MultiSteps(chain(clip, adam), every_k_schedule=k)``: each
micro-step's gradients go into a running mean (optax's Welford form,
``acc + (g - acc) / (n + 1)``); the k-th micro-step clips that mean and
applies one Adam update; the other k - 1 leave the parameters and the Adam
state as they are.

Data parallelism (``dp``, a :class:`ldm3d_torch.parallel.mesh.DataParallel`):
each micro-step's gradients are first averaged over the ranks (one
all-reduce), so every rank clips and applies the update of the global batch.
ZeRO-1 and FSDP keep this optimizer's arithmetic and change where its state
lives (:mod:`ldm3d_torch.parallel.zero`, :mod:`ldm3d_torch.parallel.fsdp`);
:meth:`TrainState.state_dict` gives the one-process layout under all three.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

__all__ = ["ClippedAdam", "TrainState", "clip_by_global_norm_", "global_norm"]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element, fp32 (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def full_tensor(t):
    """A sharded tensor (an FSDP ``DTensor``) gathered whole; any other value
    as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


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
    """Global-norm clip, then AdamW (by default b1 0.9, b2 0.999, eps 1e-8)
    at the learning rate ``lr_schedule(count)`` of the update's count, as
    optax's ``adamw``: every parameter decays by ``lr * weight_decay`` times
    its value before the update, besides the Adam step
    (``torch.optim.AdamW``'s decoupled decay is the same sum). At the
    default ``weight_decay`` 0 the decay multiplies by exactly 1: Adam.

    With ``grad_accum = k > 1`` an update is emitted every k-th micro-step
    (the module docstring); ``lr_schedule`` is then indexed by the emitted
    updates' count, as the inner optimizer of ``optax.MultiSteps`` is (wrap
    a micro-step schedule in ``training.stage1._accum_schedule``). The
    running mean and the micro-step index are in :meth:`state_dict`, so a
    resume continues mid-accumulation."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr_schedule: Callable[[int], float],
                 grad_clip: float = 1.0, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, grad_accum: int = 1,
                 dp=None):
        grad_accum = max(1, grad_accum)  # as JAX: MultiSteps only above 1
        self.dp = dp
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.grad_accum = grad_accum
        self.mini_step = 0
        self.acc_grads = ([torch.zeros_like(p) for p in self.params] if grad_accum > 1
                          else None)
        self.adam = torch.optim.AdamW(self.params, lr=lr_schedule(0), betas=betas, eps=eps,
                                      weight_decay=weight_decay)

    def _adam_over(self, params: list) -> torch.optim.AdamW:
        """A new AdamW over ``params`` with this optimizer's hyperparameters
        (ZeRO-1 and FSDP rebuild it over their shards)."""
        import inspect

        accepted = inspect.signature(torch.optim.AdamW.__init__).parameters
        group = self.adam.param_groups[0]
        return torch.optim.AdamW(params, **{k: v for k, v in group.items()
                                            if k != "params" and k in accepted})

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self, count: int) -> torch.Tensor:
        """One micro-step at micro-step ``count`` (0-based): with no
        accumulation, clip the parameters' gradients and apply one Adam
        update; with ``grad_accum = k``, add them to the running mean and,
        on the k-th micro-step, clip the mean and apply the update of count
        ``count // k``. Returns the micro-step gradients' global norm (the
        norm before the clip). A parameter that got no gradient takes a
        zero one, as optax does."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        self._reduce_grads(grads)
        if self.acc_grads is None:
            norm = self._clip(grads)
            self._adam_step(count)
            return norm
        norm = self._global_norm(grads)
        n = self.mini_step
        for acc, g in zip(self.acc_grads, grads):
            acc.add_((g - acc) / (n + 1))
        if n + 1 < self.grad_accum:
            self.mini_step = n + 1
            return norm
        self.mini_step = 0
        for p, acc in zip(self.params, self.acc_grads):
            p.grad = acc
        self._clip(self.acc_grads)
        self._adam_step(count // self.grad_accum)
        self.zero_grad()
        for acc in self.acc_grads:
            acc.zero_()
        return norm

    def _reduce_grads(self, grads: list[torch.Tensor]) -> None:
        """Average the micro-step's gradients over the data-parallel ranks."""
        if self.dp is not None:
            self.dp.all_reduce_mean_(grads)

    def _global_norm(self, tensors: list[torch.Tensor]) -> torch.Tensor:
        return global_norm(tensors)

    def _clip(self, tensors: list[torch.Tensor]) -> torch.Tensor:
        return clip_by_global_norm_(tensors, self.grad_clip, self._global_norm(tensors))

    def _adam_step(self, count: int) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.lr_schedule(count)
        self.adam.step()

    def _adam_state_dict(self) -> dict:
        return self.adam.state_dict()

    def _load_adam_state(self, state: dict) -> None:
        self.adam.load_state_dict(state)

    def state_dict(self) -> dict:
        """``torch.optim.AdamW``'s state_dict of the one-process optimizer
        (whole moments at any world size), with ``accum`` under accumulation."""
        state = self._adam_state_dict()
        if self.acc_grads is not None:
            state["accum"] = {"mini_step": self.mini_step,
                              "acc_grads": [full_tensor(a).clone() for a in self.acc_grads]}
        return state

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        accum = state.pop("accum", None)
        if (accum is None) != (self.acc_grads is None):
            raise ValueError("the checkpoint's optimizer was saved with another --grad-accum "
                             "setting than this run's")
        self._load_adam_state(state)
        if accum is not None:
            if len(accum["acc_grads"]) != len(self.acc_grads):
                raise ValueError("the checkpoint's accumulator does not match the parameters")
            self.mini_step = int(accum["mini_step"])
            for acc, saved in zip(self.acc_grads, accum["acc_grads"]):
                acc.copy_(saved)


class TrainState:
    """``model`` + ``optimizer`` + ``step`` (updates applied) + EMA params."""

    def __init__(self, model: torch.nn.Module, optimizer: ClippedAdam, ema_decay: float = 0.0,
                 ema_every: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.step = 0
        self.ema_decay = ema_decay
        # EMA cadence in micro-steps: under gradient accumulation the decay
        # applies once per emitted update, as the JAX rule (ema_every = k)
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
        """The one-process layout (whole tensors) at any world size: a
        collective under FSDP and ZeRO-1, so every rank calls it."""
        out = {"params": self.model_state_dict(),
               "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self.ema_params is not None:
            out["ema_params"] = self.ema_state_dict()
        return out

    def model_state_dict(self) -> dict:
        """The model's params as whole tensors (the ``best`` role's state_dict)."""
        return {k: full_tensor(v) for k, v in self.model.state_dict().items()}

    def ema_state_dict(self) -> dict:
        """The EMA params as whole tensors (the ``ema`` role's state_dict)."""
        return {k: full_tensor(v) for k, v in self.ema_params.items()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if self.ema_params is not None:
            if "ema_params" not in state:
                raise KeyError("the checkpoint holds no EMA params, but this run keeps an EMA")
            for name, t in state["ema_params"].items():
                self.ema_params[name].copy_(t)
