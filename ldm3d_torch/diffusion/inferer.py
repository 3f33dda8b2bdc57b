"""Latent diffusion inferer: training-step noising, the reverse loop and the
VAE decode.

Counterpart of ``ldm3d_tpu/diffusion/inferer.py``. The JAX package compiles
the reverse loop as one ``lax.scan``; here it is a Python loop over the
scheduler's timesteps, one UNet call per step. A sampler that adds noise
(DDPM, DDIM with eta > 0) draws it per step from the caller's ``generator``,
or takes the caller's list of per-step noises. A multistep sampler
(DPM-Solver++) carries the last two x0 predictions from step to step.

Conditioning: ``condition=None`` samples unconditionally; a
``(B, d, h, w, C_cond)`` condition is channel-concatenated every step
("concat" mode). Classifier-free guidance runs the conditional and
unconditional branches (zero null condition) as one 2B-batch UNet call.

:class:`CapturedSampler` is the counterpart of the JAX loop compiled as one
program (the ``lax.scan``, and with the decode the CLI's ``--fused-decode``):
on the card one step of the loop (a guided UNet call and the scheduler's
update, reading its timestep and coefficients from the scheduler's
:class:`~ldm3d_torch.diffusion.schedulers.StepTable` on the device at a
device step index) is captured once as a CUDA graph and replayed once a
step, and the decode is a second graph; on the CPU the same step body runs
eagerly over the same table.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from ldm3d_torch.diffusion.schedulers import table_step

__all__ = ["noise_prediction_inputs", "training_targets", "guided_model_pred",
           "sample_latents", "sample", "CapturedSampler"]

UNetApply = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def noise_prediction_inputs(scheduler, latents: torch.Tensor, noise: torch.Tensor,
                            timesteps: torch.Tensor,
                            condition: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The UNet input of a training step: noisy (scaled) latents, with the
    condition channel-concatenated."""
    noisy = scheduler.add_noise(latents, noise, timesteps)
    if condition is not None:
        noisy = torch.cat([noisy, condition.to(noisy.dtype)], dim=-1)
    return noisy


def training_targets(scheduler, latents: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
    """Regression target per ``scheduler.prediction_type``."""
    if scheduler.prediction_type == "epsilon":
        return noise
    if scheduler.prediction_type == "sample":
        return latents
    if scheduler.prediction_type == "v_prediction":
        return scheduler.velocity(latents, noise, timesteps)
    raise ValueError(scheduler.prediction_type)


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
                   guidance_scale: float = 1.0,
                   generator: Optional[torch.Generator] = None,
                   step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Run the reverse loop in latent space from ``noise`` ``(B, d, h, w, C)``.

    ``step_noises``, when given, holds one standard-normal tensor of
    ``noise``'s shape per step, used in place of draws from ``generator``."""
    timesteps = scheduler.timesteps
    if step_noises is not None and len(step_noises) != len(timesteps):
        raise ValueError(f"{len(step_noises)} step noises for {len(timesteps)} steps")
    x = noise

    def model_pred(x, t):
        t_b = torch.full((noise.shape[0],), t, dtype=torch.int32, device=noise.device)
        return guided_model_pred(unet_apply, x, t_b, condition, guidance_scale)

    if getattr(scheduler, "multistep", False):
        # the zero inits never contribute: c2[0] = c3[0] = c3[1] = 0
        x0_prev, x0_prev2 = torch.zeros_like(noise), torch.zeros_like(noise)
        for i, t in enumerate(timesteps):
            x, x0 = scheduler.step_multistep(model_pred(x, t), i, t, x, x0_prev, x0_prev2)
            x0_prev, x0_prev2 = x0, x0_prev
        return x
    for i, t in enumerate(timesteps):
        pred = model_pred(x, t)
        if step_noises is not None:
            x = scheduler.step_with_noise(pred, t, x, step_noises[i].to(x.device))
        else:
            x = scheduler.step(pred, t, x, generator)
    return x


@torch.no_grad()
def sample(unet_apply: UNetApply, decode_apply: Callable[[torch.Tensor], torch.Tensor],
           scheduler, noise: torch.Tensor, condition: Optional[torch.Tensor] = None,
           scale_factor: float = 1.0, guidance_scale: float = 1.0,
           generator: Optional[torch.Generator] = None,
           step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Reverse loop, then divide by ``scale_factor`` and decode."""
    latents = sample_latents(unet_apply, scheduler, noise, condition, guidance_scale, generator,
                             step_noises)
    return decode_apply(latents / torch.tensor(scale_factor, dtype=latents.dtype))


class CapturedSampler:
    """The reverse loop, ``/ scale_factor`` and the decode of one sampling
    configuration (scheduler, guidance, latent batch shape, dtype, condition
    or none, device), run from static buffers.

    On CUDA :meth:`capture` (or else the first call) warms the step and the
    decode up on a side stream (the kernels built, cuDNN's plans and the
    GroupNorm workspace made), then captures one step as a CUDA graph (two
    where some steps add noise and others do not: one graph for each) and
    the decode as another, sharing the first graph's memory pool. A sample copies its noise, condition and
    pre-drawn step noises into the buffers, then replays the step graph once
    a step and the decode graph once: the host does nothing between the
    replays but issue them, under ``torch.cuda.set_sync_debug_mode("error")``.
    The graphs are reused by every later call. A capture or replay that
    fails raises. On the CPU the same step body runs eagerly, step by step,
    over the same table (the plain version the tests hold).

    ``capture_ms`` is the host time of the warm-up and the captures,
    ``warmup_launches`` the kernel launches the warm-up made (as
    ``ops.graphs.launch_counts`` differences), ``last_ms`` the device ms of
    the last sample's denoise and decode (CUDA events around the replays,
    after the inputs' copies; host clock on the CPU).
    """

    def __init__(self, unet_apply: UNetApply, decode_apply: Optional[Callable], scheduler,
                 latent_shape: Sequence[int], dtype: torch.dtype, device,
                 condition_shape: Optional[Sequence[int]] = None, guidance_scale: float = 1.0,
                 scale_factor: float = 1.0):
        self.unet_apply, self.decode_apply = unet_apply, decode_apply
        self.table = scheduler.step_table()
        self.guidance_scale, self.scale_factor = guidance_scale, scale_factor
        self.device = torch.device(device)
        steps = len(self.table.noisy)
        dev = self.device
        self.x = torch.zeros(tuple(latent_shape), dtype=dtype, device=dev)
        multistep = self.table.kind == "multistep"
        self.x0_prev = torch.zeros_like(self.x) if multistep else None
        self.x0_prev2 = torch.zeros_like(self.x) if multistep else None
        self.cond = (None if condition_shape is None
                     else torch.zeros(tuple(condition_shape), dtype=dtype, device=dev))
        # the device step index, once a batch row (t_b's gather) and once alone
        self.index_b = torch.zeros((self.x.shape[0],), dtype=torch.int64, device=dev)
        self.index = self.index_b[:1]
        self.timesteps = self.table.timesteps.to(dev)
        self.values = self.table.values.to(dev)
        self.noises = (torch.zeros((steps, *self.x.shape), dtype=torch.float32, device=dev)
                       if self.table.draws_noise else None)
        self.out = None
        self.graphs: dict = {}
        self.decode_graph = None
        self.capture_ms = 0.0
        self.warmup_launches: dict = {}
        self.last_ms: dict = {}

    @property
    def graph_count(self) -> int:
        """The CUDA graphs captured: the step graphs and the decode's."""
        return len(self.graphs) + (self.decode_graph is not None)

    @property
    def draws_noise(self) -> bool:
        """Whether a sample takes one pre-drawn standard normal a step."""
        return self.table.draws_noise

    def _step_body(self, noisy: bool) -> None:
        """One step at the device step index: the guided model call, the
        table step, the carries, the index advanced."""
        t_b = self.timesteps.index_select(0, self.index_b)
        pred = guided_model_pred(self.unet_apply, self.x, t_b, self.cond, self.guidance_scale)
        row = dict(zip(self.table.columns, self.values.index_select(0, self.index)[0].unbind()))
        z = self.noises.index_select(0, self.index)[0] if noisy else None
        if self.x0_prev is not None:
            x_next, x0 = table_step(self.table, row, pred, self.x, z, self.x0_prev, self.x0_prev2)
            self.x0_prev2.copy_(self.x0_prev)
            self.x0_prev.copy_(x0)
        else:
            x_next = table_step(self.table, row, pred, self.x, z)
        self.x.copy_(x_next)
        self.index_b.add_(1)

    def _decode_body(self) -> torch.Tensor:
        return self.decode_apply(self.x / torch.tensor(self.scale_factor, dtype=self.x.dtype))

    def _load(self, noise, condition, step_noises) -> None:
        if tuple(noise.shape) != tuple(self.x.shape):
            raise ValueError(f"noise {tuple(noise.shape)} does not match the captured latent "
                             f"shape {tuple(self.x.shape)}")
        if (condition is None) != (self.cond is None):
            raise ValueError("the condition must be given exactly when the sampler was built "
                             "with a condition shape")
        if (step_noises is None) == self.draws_noise:
            raise ValueError(f"this sampler takes {len(self.table.noisy)} step noises"
                             if self.draws_noise else "this sampler draws no step noise")
        self.x.copy_(noise)
        if condition is not None:
            self.cond.copy_(condition)
        if step_noises is not None:
            if len(step_noises) != len(self.table.noisy):
                raise ValueError(f"{len(step_noises)} step noises for "
                                 f"{len(self.table.noisy)} steps")
            stacked = torch.stack([z.float() for z in step_noises])
            if stacked.shape != self.noises.shape:
                raise ValueError(f"step noises of shape {tuple(stacked.shape[1:])}, expected "
                                 f"{tuple(self.x.shape)}")
            self.noises.copy_(stacked)
        self.index_b.zero_()
        if self.x0_prev is not None:
            self.x0_prev.zero_()
            self.x0_prev2.zero_()

    @torch.no_grad()
    def sample_latents(self, noise: torch.Tensor, condition: Optional[torch.Tensor] = None,
                       step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The reverse loop from ``noise``: :func:`sample_latents`'s result
        (with the same ``step_noises``) in a new tensor."""
        self._run(noise, condition, step_noises, decode=False)
        return self.x.clone()

    @torch.no_grad()
    def sample(self, noise: torch.Tensor, condition: Optional[torch.Tensor] = None,
               step_noises: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The reverse loop, ``/ scale_factor`` and the decode: :func:`sample`'s
        result in a new tensor."""
        if self.decode_apply is None:
            raise ValueError("this sampler was built without a decode")
        self._run(noise, condition, step_noises, decode=True)
        return self.out.clone()

    def _run(self, noise, condition, step_noises, decode: bool) -> None:
        if self.device.type == "cuda":
            if not self.graphs:
                self.capture()
            self._load(noise, condition, step_noises)
            self._replay(decode)
            return
        if self.device.type != "cpu":
            raise ValueError(f"CapturedSampler runs on cuda (graphs) or cpu, not {self.device}")
        self._load(noise, condition, step_noises)
        t0 = time.perf_counter()
        for noisy in self.table.noisy:
            self._step_body(noisy)
        t1 = time.perf_counter()
        if decode:
            self.out = self._decode_body()
        self.last_ms = {"denoise_ms": (t1 - t0) * 1e3,
                        "decode_ms": (time.perf_counter() - t1) * 1e3}

    def _replay(self, decode: bool) -> None:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        sequence = [self.graphs[noisy] for noisy in self.table.noisy]
        debug_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            events[0].record()
            for graph in sequence:
                graph.replay()
            events[1].record()
            if decode:
                self.decode_graph.replay()
            events[2].record()
        finally:
            torch.cuda.set_sync_debug_mode(debug_mode)
        events[2].synchronize()
        self.last_ms = {"denoise_ms": events[0].elapsed_time(events[1]),
                        "decode_ms": events[1].elapsed_time(events[2])}

    def capture(self) -> None:
        """Warm up each step graph's body and the decode on a side stream,
        then capture them (on the card; the first sample does it if no one
        has)."""
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs are captured on the card, not on {self.device}")
        from ldm3d_torch.ops.graphs import CountedGraph, launch_counts, launch_delta

        t0 = time.perf_counter()
        kinds = sorted(set(self.table.noisy))
        before = launch_counts()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream), torch.no_grad():
            for noisy in kinds:
                self.index_b.zero_()
                self._step_body(noisy)
            if self.decode_apply is not None:
                self._decode_body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.warmup_launches = launch_delta(launch_counts(), before)
        pool = None
        with torch.no_grad():
            for noisy in kinds:
                graph = CountedGraph()
                graph.capture(lambda: self._step_body(noisy), pool=pool, stream=stream)
                pool = graph.pool()
                self.graphs[noisy] = graph
            if self.decode_apply is not None:
                self.decode_graph = CountedGraph()
                self.out = self.decode_graph.capture(self._decode_body, pool=pool, stream=stream)
        torch.cuda.synchronize(self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
