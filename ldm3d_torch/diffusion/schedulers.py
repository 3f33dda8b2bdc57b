"""Noise schedule tables and the samplers.

Counterpart of ``ldm3d_tpu/diffusion/schedulers.py``: ``make_betas``,
``make_timestep_grid`` (leading and trailing), ``karras_timestep_grid``,
``distillation_grid``, ``DDPMScheduler`` (the training noiser
``add_noise``/``velocity`` and the ancestral ``step``, full or strided),
``DDIMScheduler`` (with ``eta``), ``GridDDIMScheduler`` (DDIM over an explicit
grid) and ``DPMSolverPPScheduler`` (2M/3M multistep). Step math runs in fp32
whatever the compute dtype. A step that adds noise (DDPM, DDIM with eta > 0)
draws it from a caller's ``torch.Generator`` in ``step``, or takes it as an
argument in ``step_with_noise``.

Every step is :func:`table_step` over one row of scalars (t's alpha_bar
terms and the kind's coefficients): the eager step builds its row as CPU
0-dim tensors, and :meth:`step_table` stacks the rows of the whole grid into
a :class:`StepTable`, which a step captured in a CUDA graph reads on the
device at a device step index. One body for both gives the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DDIMScheduler", "DDPMScheduler", "DPMSolverPPScheduler", "GridDDIMScheduler",
           "StepTable", "table_step", "pred_x0_and_eps", "make_betas", "make_timestep_grid",
           "distillation_grid", "karras_timestep_grid"]


def make_betas(num_train_timesteps: int, schedule: str, beta_start: float,
               beta_end: float) -> torch.Tensor:
    """fp32 beta table, computed in fp32 as the JAX package does."""
    if schedule == "linear_beta":
        return torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
    if schedule == "scaled_linear_beta":
        return torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                              dtype=torch.float32) ** 2
    if schedule == "cosine":
        s = 0.008
        steps = torch.arange(num_train_timesteps + 1, dtype=torch.float32) / num_train_timesteps
        f = torch.cos((steps + s) / (1 + s) * torch.pi / 2) ** 2
        alphas_bar = f / f[0]
        return torch.clamp(1.0 - alphas_bar[1:] / alphas_bar[:-1], 0.0, 0.999)
    raise ValueError(f"unknown beta schedule {schedule!r}")


def make_timestep_grid(num_train_timesteps: int, n: int, spacing: str) -> list[int]:
    """Descending inference timesteps of an ``n``-step strided schedule:
    ``"leading"`` ends at t=0 (MONAI ``set_timesteps`` parity), ``"trailing"``
    starts at ``num_train_timesteps - 1``."""
    stride = num_train_timesteps // n
    if spacing == "leading":
        return [i * stride for i in range(n - 1, -1, -1)]
    if spacing == "trailing":
        return [(num_train_timesteps - 1) - i * stride for i in range(n)]
    raise ValueError(
        f"timestep_spacing must be 'leading' or 'trailing', got {spacing!r}"
        + (" ('karras' spacing is grid-based: available on the dpm/dpm3 samplers and on "
           "ddim via make_sampling_scheduler/GridDDIMScheduler)" if spacing == "karras" else ""))


def karras_timestep_grid(num_train_timesteps: int, n: int, schedule: str = "scaled_linear_beta",
                         beta_start: float = 0.0015, beta_end: float = 0.0195,
                         rho: float = 7.0) -> np.ndarray:
    """Descending timesteps whose noise levels follow the Karras et al. (EDM)
    sigma spacing, each mapped to the discrete timestep of nearest
    sigma(t) = sqrt((1 - abar_t) / abar_t). Anchored at t = T-1 and t = 0.
    Raises when ``n`` is too large for the mapped timesteps to stay distinct."""
    if not (2 <= n <= num_train_timesteps):
        raise ValueError(f"karras grid needs 2 <= steps <= {num_train_timesteps}, got {n}")
    betas = make_betas(num_train_timesteps, schedule, beta_start, beta_end).numpy().astype(np.float64)
    abar = np.cumprod(1.0 - betas)
    sig = np.sqrt((1.0 - abar) / abar)  # ascending in t
    smin, smax = float(sig[0]), float(sig[-1])
    frac = np.linspace(0.0, 1.0, n)
    sigmas = (smax ** (1.0 / rho) + frac * (smin ** (1.0 / rho) - smax ** (1.0 / rho))) ** rho
    hi = np.clip(np.searchsorted(sig, sigmas), 1, num_train_timesteps - 1)
    ts = np.where(np.abs(sigmas - sig[hi - 1]) <= np.abs(sig[hi] - sigmas), hi - 1, hi)
    ts = ts.astype(np.int32)
    if len(np.unique(ts)) != n:
        raise ValueError(f"{n}-step karras grid over {num_train_timesteps} timesteps maps "
                         f"multiple steps onto the same timestep; reduce the step count")
    return ts


def distillation_grid(num_train_timesteps: int, n: int) -> np.ndarray:
    """N+1 descending boundary timesteps ``round(linspace(T-1, 0, N+1))`` of
    an N-step grid; the visited timesteps are ``grid[:-1]`` and the last jump
    goes to the terminal state."""
    if not (1 <= n <= num_train_timesteps):
        raise ValueError(f"grid steps must be in [1, {num_train_timesteps}], got {n}")
    b = np.round(np.linspace(num_train_timesteps - 1, 0, n + 1)).astype(np.int32)
    if len(np.unique(b)) != n + 1:
        raise ValueError(f"{n}-step grid over {num_train_timesteps} timesteps "
                         f"has duplicate entries; reduce the step count")
    return b


def _check_trailing_divisible(num_train_timesteps: int, n: int, spacing: str) -> None:
    """DDIM/DDPM detect the terminal jump by ``t - stride < 0``, which on a
    trailing grid holds only when ``n`` divides the schedule."""
    if spacing == "trailing" and num_train_timesteps % n:
        raise ValueError(
            f"trailing timestep_spacing requires num_inference_steps to divide "
            f"num_train_timesteps ({num_train_timesteps}); got {n}: "
            f"the final step would stop short of the terminal state")


def _noise_coeffs(alphas_cumprod: torch.Tensor, t: torch.Tensor, like: torch.Tensor):
    """(sqrt(abar_t), sqrt(1 - abar_t)) broadcast against ``like``, in its dtype.

    The sqrt runs in fp32 and only the result is cast: casting abar to bf16
    first rounds abar_0 = 0.9985 to 1.0 and zeroes sqrt(1 - abar_0)
    (``ldm3d_tpu/diffusion/schedulers.py:132-143``)."""
    a = alphas_cumprod.float().to(t.device)[t.long()]
    a = a.reshape(a.shape + (1,) * (like.dim() - a.dim()))
    return torch.sqrt(a).to(like.dtype), torch.sqrt(1.0 - a).to(like.dtype)


def pred_x0_and_eps(pred: torch.Tensor, x_t: torch.Tensor, a_t: torch.Tensor,
                    prediction_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x0_hat, eps_hat)`` of a model output at alpha_bar ``a_t`` (a tensor
    that broadcasts against ``x_t``, one value a sample or one for all), by
    division as ``ldm3d_tpu/diffusion/schedulers.py:146-161`` computes them.
    The steps of the samplers go through :func:`table_step` instead."""
    sqrt_a = torch.sqrt(a_t)
    sqrt_1ma = torch.sqrt(1.0 - a_t)
    if prediction_type == "epsilon":
        return (x_t - sqrt_1ma * pred) / sqrt_a, pred
    if prediction_type == "sample":
        return pred, (x_t - sqrt_a * pred) / sqrt_1ma
    if prediction_type == "v_prediction":
        return sqrt_a * x_t - sqrt_1ma * pred, sqrt_a * pred + sqrt_1ma * x_t
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def _draw(x_t: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """Standard-normal fp32 noise of ``x_t``'s shape, drawn on the generator's
    device and moved to ``x_t``'s."""
    device = generator.device if generator is not None else x_t.device
    z = torch.randn(x_t.shape, generator=generator, device=device, dtype=torch.float32)
    return z.to(x_t.device)


@dataclasses.dataclass
class DDIMScheduler:
    """DDIM over a strided timestep subsequence; deterministic at ``eta`` 0,
    with fresh noise of scale ``eta * sigma_t`` a step otherwise."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int = 1000
    num_inference_steps: int = 50
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_range: float = 1.0
    eta: float = 0.0
    timestep_spacing: str = "leading"
    kind = "ddim"

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        schedule: str = "scaled_linear_beta",
        beta_start: float = 0.0015,
        beta_end: float = 0.0195,
        num_inference_steps: int = 50,
        prediction_type: str = "epsilon",
        clip_sample: bool = True,
        clip_range: float = 1.0,
        eta: float = 0.0,
        timestep_spacing: str = "leading",
    ) -> "DDIMScheduler":
        if not (1 <= num_inference_steps <= num_train_timesteps):
            raise ValueError(f"num_inference_steps must be in [1, {num_train_timesteps}], "
                             f"got {num_inference_steps}")
        make_timestep_grid(num_train_timesteps, num_inference_steps, timestep_spacing)
        _check_trailing_divisible(num_train_timesteps, num_inference_steps, timestep_spacing)
        betas = make_betas(num_train_timesteps, schedule, beta_start, beta_end)
        return cls(betas=betas, alphas_cumprod=torch.cumprod(1.0 - betas, dim=0),
                   num_train_timesteps=num_train_timesteps,
                   num_inference_steps=num_inference_steps, prediction_type=prediction_type,
                   clip_sample=clip_sample, clip_range=clip_range, eta=eta,
                   timestep_spacing=timestep_spacing)

    @property
    def timesteps(self) -> list[int]:
        return make_timestep_grid(self.num_train_timesteps, self.num_inference_steps,
                                  self.timestep_spacing)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sqrt_a, sqrt_1ma = _noise_coeffs(self.alphas_cumprod, t, x0)
        return sqrt_a * x0 + sqrt_1ma * noise

    def step(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """One reverse step x_t -> x_{t - stride}. At eta > 0 its noise is a
        standard normal drawn from ``generator``; at eta 0 nothing is drawn."""
        z = _draw(x_t, generator) if self.eta > 0 else None
        return self.step_with_noise(model_output, t, x_t, z)

    def step_with_noise(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
                        z: torch.Tensor | None) -> torch.Tensor:
        """:meth:`step` with its standard-normal noise ``z`` given (unused at
        eta 0), in fp32, returned in x_t's dtype."""
        row, noisy = self._row(t)
        return table_step(self, row, model_output, x_t, _noise(z, noisy))

    @property
    def draws_noise(self) -> bool:
        """Whether :meth:`step` draws a noise (at every step, added or not)."""
        return self.eta > 0

    def _row(self, t: int):
        """The step's row (x0 columns, sqrt(abar_prev), the direction's
        coefficient, sigma) and whether it adds noise."""
        stride = self.num_train_timesteps // self.num_inference_steps
        a_t = self.alphas_cumprod[t]
        t_prev = t - stride
        a_prev = self.alphas_cumprod[t_prev] if t_prev >= 0 else torch.tensor(1.0)
        sigma = self.eta * torch.sqrt(torch.clamp((1 - a_prev) / (1 - a_t), min=1e-20)
                                      * (1 - a_t / a_prev))
        eps_coef = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0))
        return (_row(self.kind, a_t, (torch.sqrt(a_prev), eps_coef, sigma)),
                self.eta > 0 and t_prev >= 0)

    def step_table(self) -> "StepTable":
        """The rows of :meth:`step_with_noise` at each timestep."""
        return _table(self, [self._row(t) for t in self.timesteps])


@dataclasses.dataclass
class DDPMScheduler:
    """Ancestral DDPM sampler and training noiser.

    ``num_inference_steps=None`` runs the full training schedule; a smaller
    value subsamples it as MONAI's ``set_timesteps`` does (stride
    ``num_train // n``, per-step beta from the alphas-cumprod ratio of the
    visited timesteps)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int = 1000
    num_inference_steps: int | None = None
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_range: float = 1.0
    timestep_spacing: str = "leading"
    kind = "ddpm"
    draws_noise = True  # at every step; the last (t = 0) adds none

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        schedule: str = "scaled_linear_beta",
        beta_start: float = 0.0015,
        beta_end: float = 0.0195,
        num_inference_steps: int | None = None,
        prediction_type: str = "epsilon",
        clip_sample: bool = True,
        clip_range: float = 1.0,
        timestep_spacing: str = "leading",
    ) -> "DDPMScheduler":
        if num_inference_steps is not None and not (1 <= num_inference_steps <= num_train_timesteps):
            raise ValueError(f"num_inference_steps must be in [1, {num_train_timesteps}], "
                             f"got {num_inference_steps}")
        n = num_inference_steps or num_train_timesteps
        make_timestep_grid(num_train_timesteps, n, timestep_spacing)
        _check_trailing_divisible(num_train_timesteps, n, timestep_spacing)
        betas = make_betas(num_train_timesteps, schedule, beta_start, beta_end)
        return cls(betas=betas, alphas_cumprod=torch.cumprod(1.0 - betas, dim=0),
                   num_train_timesteps=num_train_timesteps,
                   num_inference_steps=num_inference_steps, prediction_type=prediction_type,
                   clip_sample=clip_sample, clip_range=clip_range,
                   timestep_spacing=timestep_spacing)

    def replace(self, **changes) -> "DDPMScheduler":
        """A copy with ``changes`` applied (``prediction_type`` for a
        distillation round after the first), as the JAX scheduler's
        ``.replace``; the tables are shared."""
        return dataclasses.replace(self, **changes)

    @property
    def _stride(self) -> int:
        return self.num_train_timesteps // (self.num_inference_steps or self.num_train_timesteps)

    @property
    def timesteps(self) -> list[int]:
        return make_timestep_grid(self.num_train_timesteps,
                                  self.num_inference_steps or self.num_train_timesteps,
                                  self.timestep_spacing)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) for per-sample timesteps ``t`` of shape (B,)."""
        sqrt_a, sqrt_1ma = _noise_coeffs(self.alphas_cumprod, t, x0)
        return sqrt_a * x0 + sqrt_1ma * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Target of v-prediction training."""
        sqrt_a, sqrt_1ma = _noise_coeffs(self.alphas_cumprod, t, x0)
        return sqrt_a * noise - sqrt_1ma * x0

    def step(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """One reverse step x_t -> x_{t - stride}; the ancestral noise is a
        standard normal drawn from ``generator`` (on the generator's device)."""
        return self.step_with_noise(model_output, t, x_t, _draw(x_t, generator))

    def step_with_noise(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
        """:meth:`step` with its standard-normal noise ``z`` given, in fp32,
        returned in x_t's dtype."""
        row, noisy = self._row(t)
        return table_step(self, row, model_output, x_t, _noise(z, noisy))

    def _row(self, t: int):
        """The step's row (x0 columns, the posterior mean's coefficients of
        x0 and x_t, the noise's standard deviation) and whether it adds
        noise (t > 0)."""
        stride = self._stride
        a_t = self.alphas_cumprod[t]
        t_prev = t - stride
        a_prev = self.alphas_cumprod[t_prev] if t_prev >= 0 else torch.tensor(1.0)
        # table lookup keeps the full-schedule path bit-exact; the effective
        # beta over a strided jump otherwise
        beta_t = self.betas[t] if stride == 1 else 1.0 - a_t / a_prev
        alpha_t = 1.0 - beta_t
        coef_x0 = torch.sqrt(a_prev) * beta_t / (1.0 - a_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t)
        var = torch.clamp((1.0 - a_prev) / (1.0 - a_t) * beta_t, min=1e-20)
        return _row(self.kind, a_t, (coef_x0, coef_xt, torch.sqrt(var))), t > 0

    def step_table(self) -> "StepTable":
        """The rows of :meth:`step_with_noise` at each timestep."""
        return _table(self, [self._row(t) for t in self.timesteps])


@dataclasses.dataclass
class GridDDIMScheduler:
    """Deterministic DDIM over an explicit strictly descending timestep grid
    (a distillation grid or a karras grid); the last visited timestep jumps
    to the terminal state (alpha_bar = 1). ``next_abar[t]`` is the successor
    state's alpha_bar at each visited t."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    grid: list[int]
    next_abar: torch.Tensor
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_range: float = 1.0
    kind = "ddim"
    draws_noise = False

    @classmethod
    def create(
        cls,
        timesteps,
        num_train_timesteps: int = 1000,
        schedule: str = "scaled_linear_beta",
        beta_start: float = 0.0015,
        beta_end: float = 0.0195,
        prediction_type: str = "epsilon",
        clip_sample: bool = True,
        clip_range: float = 1.0,
    ) -> "GridDDIMScheduler":
        ts = np.asarray(timesteps, dtype=np.int64)
        if ts.ndim != 1 or len(ts) < 1:
            raise ValueError("timesteps must be a 1-D sequence")
        if np.any(np.diff(ts) >= 0):
            raise ValueError("timesteps must be strictly descending")
        if ts[0] >= num_train_timesteps or ts[-1] < 0:
            raise ValueError(f"timesteps out of range [0, {num_train_timesteps})")
        betas = make_betas(num_train_timesteps, schedule, beta_start, beta_end)
        abar = torch.cumprod(1.0 - betas, dim=0)
        succ = torch.ones((num_train_timesteps,), dtype=torch.float32)
        succ[torch.from_numpy(ts[:-1])] = abar[torch.from_numpy(ts[1:])]
        return cls(betas=betas, alphas_cumprod=abar, grid=[int(t) for t in ts], next_abar=succ,
                   num_train_timesteps=num_train_timesteps, prediction_type=prediction_type,
                   clip_sample=clip_sample, clip_range=clip_range)

    @property
    def num_inference_steps(self) -> int:
        return len(self.grid)

    @property
    def timesteps(self) -> list[int]:
        return self.grid

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sqrt_a, sqrt_1ma = _noise_coeffs(self.alphas_cumprod, t, x0)
        return sqrt_a * x0 + sqrt_1ma * noise

    def step(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """One deterministic step from ``t`` to its grid successor; draws nothing."""
        return self.step_with_noise(model_output, t, x_t, None)

    def step_with_noise(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
                        z: torch.Tensor | None) -> torch.Tensor:
        return table_step(self, self._row(t)[0], model_output, x_t)

    def _row(self, t: int):
        """:meth:`DDIMScheduler._row` of a step to the grid successor (sigma
        0, no noise)."""
        a_prev = self.next_abar[t]
        return (_row(self.kind, self.alphas_cumprod[t],
                     (torch.sqrt(a_prev), torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)),
                      torch.zeros(()))), False)

    def step_table(self) -> "StepTable":
        """The rows of :meth:`step_with_noise` at each grid timestep."""
        return _table(self, [self._row(t) for t in self.timesteps])


@dataclasses.dataclass
class DPMSolverPPScheduler:
    """DPM-Solver++ 2M (``solver_order=2``) or 3M: a deterministic multistep
    ODE solver with lower-order warm-up and a first-order terminal step.

    Every coefficient is a precomputed fp32 table indexed by the step, as in
    the JAX package (whose docstring derives them):

        x_{i+1} = c_x[i] x_i + c_d[i] x0_i + c2[i] (x0_i - x0_{i-1})
                  + c3[i] (x0_{i-1} - x0_{i-2})

    The caller carries the last two x0 predictions (``multistep`` is True)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    c_x: torch.Tensor
    c_d: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor
    grid: list[int]
    num_train_timesteps: int = 1000
    num_inference_steps: int = 20
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_range: float = 1.0
    multistep: bool = True
    solver_order: int = 2
    timestep_spacing: str = "leading"
    kind = "multistep"
    draws_noise = False

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        schedule: str = "scaled_linear_beta",
        beta_start: float = 0.0015,
        beta_end: float = 0.0195,
        num_inference_steps: int = 20,
        prediction_type: str = "epsilon",
        clip_sample: bool = True,
        clip_range: float = 1.0,
        solver_order: int = 2,
        timestep_spacing: str = "leading",
    ) -> "DPMSolverPPScheduler":
        if not (1 <= num_inference_steps <= num_train_timesteps):
            raise ValueError(f"num_inference_steps must be in [1, {num_train_timesteps}], "
                             f"got {num_inference_steps}")
        if solver_order not in (2, 3):
            raise ValueError(f"solver_order must be 2 or 3, got {solver_order}")
        betas = make_betas(num_train_timesteps, schedule, beta_start, beta_end)
        a_bar = torch.cumprod(1.0 - betas, dim=0)
        if timestep_spacing == "karras":
            ts = [int(t) for t in karras_timestep_grid(num_train_timesteps, num_inference_steps,
                                                       schedule, beta_start, beta_end)]
        else:
            ts = make_timestep_grid(num_train_timesteps, num_inference_steps, timestep_spacing)
        # (alpha, sigma) at each visited state, then the terminal x0 state
        a_grid = torch.cat([a_bar[torch.tensor(ts)], torch.ones((1,), dtype=torch.float32)])
        alpha, sigma = torch.sqrt(a_grid), torch.sqrt(1.0 - a_grid)
        c_x = sigma[1:] / torch.clamp(sigma[:-1], min=1e-12)
        exp_neg_h = (sigma[1:] * alpha[:-1]) / torch.clamp(sigma[:-1] * alpha[1:], min=1e-12)
        c_d = alpha[1:] * (1.0 - exp_neg_h)
        lam = (torch.log(torch.clamp(alpha[:-1], min=1e-12))
               - torch.log(torch.clamp(sigma[:-1], min=1e-12)))
        h = lam[1:] - lam[:-1]  # h_i for i in [0, N-2]
        n = num_inference_steps
        c2 = torch.zeros((n,), dtype=torch.float32)
        c3 = torch.zeros((n,), dtype=torch.float32)
        if n > 2:
            ratio = h[1:] / torch.clamp(h[:-1], min=1e-12)
            c2[1:n - 1] = 0.5 * c_d[1:n - 1] * ratio
        if solver_order == 3 and n > 3:
            # steps i in [2, N-2]: the full 3M update (step 1 keeps its 2M c2)
            i = torch.arange(2, n - 1)
            h_i, h_p, h_pp = h[i], h[i - 1], h[i - 2]
            r0 = h_p / torch.clamp(h_i, min=1e-12)
            r1 = h_pp / torch.clamp(h_i, min=1e-12)
            u, v = 1.0 / torch.clamp(r0, min=1e-12), 1.0 / torch.clamp(r1, min=1e-12)
            w = r0 / torch.clamp(r0 + r1, min=1e-12)
            phi1 = 1.0 - exp_neg_h[i]
            a_next = alpha[i + 1]
            p1 = a_next * (1.0 - phi1 / h_i)
            p2 = a_next * (0.5 - (h_i - phi1) / (h_i * h_i))
            c2[i] = p1 * (1.0 + w) * u + p2 * u / (r0 + r1)
            c3[i] = -(p1 * w * v + p2 * v / (r0 + r1))
        return cls(betas=betas, alphas_cumprod=a_bar, c_x=c_x, c_d=c_d, c2=c2, c3=c3, grid=ts,
                   num_train_timesteps=num_train_timesteps,
                   num_inference_steps=num_inference_steps, prediction_type=prediction_type,
                   clip_sample=clip_sample, clip_range=clip_range, solver_order=solver_order,
                   timestep_spacing=timestep_spacing)

    @property
    def timesteps(self) -> list[int]:
        return self.grid

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sqrt_a, sqrt_1ma = _noise_coeffs(self.alphas_cumprod, t, x0)
        return sqrt_a * x0 + sqrt_1ma * noise

    def step_multistep(self, model_output: torch.Tensor, i: int, t: int, x_t: torch.Tensor,
                       x0_prev: torch.Tensor, x0_prev2: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """One 2M/3M update at step index ``i`` (timestep ``t``); returns
        ``(x_next, x0_current)``, both in x_t's dtype."""
        if self.solver_order >= 3 and x0_prev2 is None:
            raise ValueError("solver_order=3 requires the x0_prev2 carry")
        return table_step(self, self._row(i, t), model_output, x_t, None, x0_prev, x0_prev2)

    def _row(self, i: int, t: int) -> dict:
        """The row of step index ``i`` (timestep ``t``): the x0 columns and
        c_x, c_d, c2, c3."""
        return _row(self.kind, self.alphas_cumprod[t],
                    (self.c_x[i], self.c_d[i], self.c2[i], self.c3[i]))

    def step_table(self) -> "StepTable":
        """The rows of :meth:`step_multistep` at each step index."""
        return _table(self, [(self._row(i, t), False) for i, t in enumerate(self.grid)])


# The columns of a StepTable: the four x0 columns of every kind (the
# reciprocals are those PyTorch's CUDA division by a CPU scalar multiplies
# by), then the kind's own coefficients.
_X0_COLUMNS = ("sqrt_a", "sqrt_1ma", "inv_sqrt_a", "inv_sqrt_1ma")
TABLE_COLUMNS = {"ddim": _X0_COLUMNS + ("x0_coef", "eps_coef", "sigma"),
                 "ddpm": _X0_COLUMNS + ("coef_x0", "coef_xt", "sqrt_var"),
                 "multistep": _X0_COLUMNS + ("c_x", "c_d", "c2", "c3")}


@dataclasses.dataclass
class StepTable:
    """The rows of a scheduler's steps over its grid: ``timesteps`` (N,)
    int32; ``values`` (N, len(columns)) fp32, one row a step, in the columns
    of ``TABLE_COLUMNS[kind]``; ``noisy[i]`` whether step i adds its noise;
    ``draws_noise`` whether the eager loop draws a noise at every step
    (added or not). ``prediction_type``, ``clip_sample``, ``clip_range`` and
    ``solver_order`` are the scheduler's."""

    kind: str
    timesteps: torch.Tensor
    values: torch.Tensor
    noisy: tuple
    draws_noise: bool
    prediction_type: str
    clip_sample: bool
    clip_range: float
    solver_order: int = 2

    @property
    def columns(self) -> tuple:
        return TABLE_COLUMNS[self.kind]


def _row(kind: str, a_t: torch.Tensor, coefs) -> dict:
    """A step's row of ``kind`` at abar_t, by column, as fp32 0-dim CPU
    tensors: sqrt(abar_t), sqrt(1 - abar_t), their reciprocals in fp32 as a
    C++ float division gives them, then the kind's ``coefs``."""
    sqrt_a, sqrt_1ma = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    one = np.float32(1.0)
    values = [sqrt_a, sqrt_1ma, torch.tensor(one / np.float32(sqrt_a.item())),
              torch.tensor(one / np.float32(sqrt_1ma.item())), *coefs]
    return {c: torch.as_tensor(v, dtype=torch.float32)
            for c, v in zip(TABLE_COLUMNS[kind], values, strict=True)}


def _noise(z: torch.Tensor | None, noisy: bool) -> torch.Tensor | None:
    """The noise a step adds: ``z`` where it adds one, else None."""
    if noisy and z is None:
        raise ValueError("this step adds noise: its standard normal z is required")
    return z if noisy else None


def _table(sched, rows: list) -> StepTable:
    """``sched``'s StepTable from its (row, adds noise) at each step."""
    values = torch.stack([torch.stack([row[c] for c in TABLE_COLUMNS[sched.kind]])
                          for row, _ in rows])
    return StepTable(sched.kind, torch.tensor(list(sched.timesteps), dtype=torch.int32), values,
                     tuple(noisy for _, noisy in rows), sched.draws_noise,
                     sched.prediction_type, sched.clip_sample, sched.clip_range,
                     getattr(sched, "solver_order", 2))


def _div(num: torch.Tensor, s: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``num / s``, ``s`` a 0-dim tensor and ``inv`` its fp32 reciprocal. On
    the card a product with ``inv``: PyTorch's CUDA division by a CPU scalar
    is that product, so a row on the device gives the bits of a row on the
    CPU. On the CPU a division."""
    return num * inv if num.is_cuda else num / s


def table_step(table, row: dict, model_output: torch.Tensor, x_t: torch.Tensor,
               z: torch.Tensor | None = None, x0_prev: torch.Tensor | None = None,
               x0_prev2: torch.Tensor | None = None):
    """One step from ``row``, a dict from the columns of
    ``TABLE_COLUMNS[table.kind]`` to 0-dim fp32 tensors (on the CPU, or on
    x_t's device), in fp32 and returned in x_t's dtype. ``table`` is a
    :class:`StepTable` or the scheduler itself: its ``kind``,
    ``prediction_type``, ``clip_sample``, ``clip_range`` and, for the
    multistep kind, ``solver_order`` are read. ``z`` (the step's standard
    normal) is added only when given; the multistep kind takes the x0
    carries and returns ``(x_next, x0)``."""
    x32 = x_t.float()
    pred = model_output.float()
    sqrt_a, sqrt_1ma = row["sqrt_a"], row["sqrt_1ma"]
    need_eps = table.kind == "ddim"
    if table.prediction_type == "epsilon":
        x0, eps = _div(x32 - sqrt_1ma * pred, sqrt_a, row["inv_sqrt_a"]), pred
    elif table.prediction_type == "sample":
        x0 = pred
        eps = _div(x32 - sqrt_a * pred, sqrt_1ma, row["inv_sqrt_1ma"]) if need_eps else None
    elif table.prediction_type == "v_prediction":
        x0 = sqrt_a * x32 - sqrt_1ma * pred
        eps = sqrt_a * pred + sqrt_1ma * x32 if need_eps else None
    else:
        raise ValueError(f"unknown prediction_type {table.prediction_type!r}")
    if table.clip_sample:
        x0 = torch.clamp(x0, -table.clip_range, table.clip_range)
        if need_eps:
            eps = _div(x32 - sqrt_a * x0, sqrt_1ma, row["inv_sqrt_1ma"])
    if table.kind == "ddim":
        dir_xt = row["eps_coef"] * eps
        sample = row["x0_coef"] * x0 + dir_xt
        if z is not None:
            sample = sample + row["sigma"] * z.float()
        return sample.to(x_t.dtype)
    if table.kind == "ddpm":
        mean = row["coef_x0"] * x0 + row["coef_xt"] * x32
        sample = mean + row["sqrt_var"] * z.float() if z is not None else mean
        return sample.to(x_t.dtype)
    x_next = row["c_x"] * x32 + row["c_d"] * x0 + row["c2"] * (x0 - x0_prev.float())
    if table.solver_order >= 3:
        x_next = x_next + row["c3"] * (x0_prev.float() - x0_prev2.float())
    return x_next.to(x_t.dtype), x0.to(x_t.dtype)
