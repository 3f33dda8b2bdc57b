"""Noise schedule tables, the DDPM noiser/sampler and the DDIM sampler.

Counterpart of ``ldm3d_tpu/diffusion/schedulers.py``: ``make_betas``,
``make_timestep_grid`` (leading and trailing), ``DDPMScheduler`` (the
training noiser ``add_noise``/``velocity`` and the ancestral ``step``, whose
noise comes from a caller's ``torch.Generator``) and the deterministic
(eta 0) ``DDIMScheduler``. Step math runs in fp32 whatever the compute dtype.
DPM-Solver++ and the grid (distilled) DDIM are not ported yet (ROADMAP.md
queue A).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DDIMScheduler", "DDPMScheduler", "make_betas", "make_timestep_grid"]


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
    if spacing == "karras":
        raise NotImplementedError("karras timestep spacing is not ported yet: "
                                  "ROADMAP.md queue A, 'DDPM / DPM-Solver++ / GridDDIM samplers'")
    raise ValueError(f"timestep_spacing must be 'leading' or 'trailing', got {spacing!r}")


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


def _pred_x0_and_eps(pred, x_t, a_t, prediction_type: str):
    """Convert a model output into (x0_hat, eps_hat) given alpha_bar_t."""
    sqrt_a = torch.sqrt(a_t)
    sqrt_1ma = torch.sqrt(1.0 - a_t)
    if prediction_type == "epsilon":
        return (x_t - sqrt_1ma * pred) / sqrt_a, pred
    if prediction_type == "sample":
        return pred, (x_t - sqrt_a * pred) / sqrt_1ma
    if prediction_type == "v_prediction":
        return sqrt_a * x_t - sqrt_1ma * pred, sqrt_a * pred + sqrt_1ma * x_t
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


@dataclasses.dataclass
class DDIMScheduler:
    """Deterministic (eta 0) DDIM over a strided timestep subsequence."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    num_train_timesteps: int = 1000
    num_inference_steps: int = 50
    prediction_type: str = "epsilon"
    clip_sample: bool = True
    clip_range: float = 1.0
    timestep_spacing: str = "leading"

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
        if eta != 0.0:
            raise NotImplementedError("DDIM with eta > 0 is not ported yet: ROADMAP.md "
                                      "queue A, 'DDPM / DPM-Solver++ / GridDDIM samplers'")
        if not (1 <= num_inference_steps <= num_train_timesteps):
            raise ValueError(f"num_inference_steps must be in [1, {num_train_timesteps}], "
                             f"got {num_inference_steps}")
        make_timestep_grid(num_train_timesteps, num_inference_steps, timestep_spacing)
        _check_trailing_divisible(num_train_timesteps, num_inference_steps, timestep_spacing)
        betas = make_betas(num_train_timesteps, schedule, beta_start, beta_end)
        return cls(betas=betas, alphas_cumprod=torch.cumprod(1.0 - betas, dim=0),
                   num_train_timesteps=num_train_timesteps,
                   num_inference_steps=num_inference_steps, prediction_type=prediction_type,
                   clip_sample=clip_sample, clip_range=clip_range,
                   timestep_spacing=timestep_spacing)

    @property
    def timesteps(self) -> list[int]:
        return make_timestep_grid(self.num_train_timesteps, self.num_inference_steps,
                                  self.timestep_spacing)

    def step(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """One reverse step x_t -> x_{t - stride}, in fp32, returned in x_t's
        dtype. Deterministic: ``generator`` is taken for the sampler loop's
        sake and draws nothing."""
        stride = self.num_train_timesteps // self.num_inference_steps
        x32 = x_t.float()
        pred = model_output.float()
        a_t = self.alphas_cumprod[t]
        t_prev = t - stride
        a_prev = self.alphas_cumprod[t_prev] if t_prev >= 0 else torch.tensor(1.0)

        x0, eps = _pred_x0_and_eps(pred, x32, a_t, self.prediction_type)
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_range, self.clip_range)
            eps = (x32 - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
        return (torch.sqrt(a_prev) * x0 + dir_xt).to(x_t.dtype)


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
        device = generator.device if generator is not None else x_t.device
        z = torch.randn(x_t.shape, generator=generator, device=device, dtype=torch.float32)
        return self.step_with_noise(model_output, t, x_t, z.to(x_t.device))

    def step_with_noise(self, model_output: torch.Tensor, t: int, x_t: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
        """:meth:`step` with its standard-normal noise ``z`` given, in fp32,
        returned in x_t's dtype."""
        x32 = x_t.float()
        pred = model_output.float()
        stride = self._stride
        a_t = self.alphas_cumprod[t]
        t_prev = t - stride
        a_prev = self.alphas_cumprod[t_prev] if t_prev >= 0 else torch.tensor(1.0)
        # table lookup keeps the full-schedule path bit-exact; the effective
        # beta over a strided jump otherwise
        beta_t = self.betas[t] if stride == 1 else 1.0 - a_t / a_prev
        alpha_t = 1.0 - beta_t

        x0, _ = _pred_x0_and_eps(pred, x32, a_t, self.prediction_type)
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_range, self.clip_range)
        coef_x0 = torch.sqrt(a_prev) * beta_t / (1.0 - a_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t)
        mean = coef_x0 * x0 + coef_xt * x32
        var = torch.clamp((1.0 - a_prev) / (1.0 - a_t) * beta_t, min=1e-20)
        sample = mean + torch.sqrt(var) * z.float() if t > 0 else mean
        return sample.to(x_t.dtype)
