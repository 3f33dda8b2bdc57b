"""Rank-side functions of the port's data-parallel tests (no JAX here).

Each runs on every rank of a :class:`ldm3d_torch.parallel.launch.RankPool`
(the default process group up, gloo on the CPU), or in the test process
itself with ``dp=None`` for the one-process reference. Models come from a
config dict and state_dicts of numpy arrays, batches and draws as numpy
arrays of the GLOBAL batch: each rank takes its rows.
"""

from __future__ import annotations

import contextlib
import copy
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ldm3d_torch.configs import define_instance
from ldm3d_torch.parallel import DataParallel
from ldm3d_torch.parallel.fsdp import shard_train_state_fsdp
from ldm3d_torch.parallel.zero import shard_train_state_zero
from ldm3d_torch.training import (
    DistillConfig,
    DistillDraws,
    Stage1Config,
    Stage1Draws,
    Stage2Config,
    Stage2Draws,
    TrainState,
    make_diffusion_optimizer,
    make_distillation_step,
    make_optimizer,
    make_stage1_train_step,
    make_stage2_train_step,
    make_stage2_train_step_latents,
)

torch.set_num_threads(1)


def _t(tree):
    """numpy arrays (nested in dicts/tuples) as tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_t(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.asarray(tree))


def _np(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _grads(model) -> dict:
    """The gradients the update applied (averaged over the ranks, clipped),
    whole."""
    from ldm3d_torch.training.state import full_tensor

    return {n: full_tensor(p.grad).detach().cpu().numpy() for n, p in model.named_parameters()
            if p.grad is not None}


def _model(cfg: dict, key: str, sd: dict):
    model = define_instance(SimpleNamespace(**cfg), key)
    model.load_state_dict(_t(sd))
    return model


def _shard(state: TrainState, mode: str, dp) -> None:
    if mode == "zero":
        shard_train_state_zero(state, dp)
    elif mode == "fsdp":
        shard_train_state_fsdp(state, dp)


def _metrics(metrics: dict, dp) -> dict:
    """The global batch's metrics: each local mean averaged over the ranks."""
    out = {}
    for k, v in metrics.items():
        v = torch.as_tensor(v).float()
        out[k] = float(dp.mean(v) if dp is not None and k != "g_grad_norm"
                       and k != "grad_norm" else v)
    return out


def stage2_latents_step(cfg, u_sd, batch, draws, lr, mode="ddp", one_process=False,
                        ema_decay=0.0):
    """One ``make_stage2_train_step_latents`` step on the global ``batch``
    with the global ``draws`` (a Stage2Draws of numpy arrays). Returns the
    metrics, the params, the one-process optimizer state and the EMA."""
    dp = None if one_process else DataParallel.current()
    unet = _model(cfg, "diffusion_def", u_sd)
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda _: lr, dp=dp),
                       ema_decay=ema_decay)
    if dp is not None:
        _shard(state, mode, dp)
    step = make_stage2_train_step_latents(unet, _sched(cfg), Stage2Config(), dp=dp)
    d = Stage2Draws(*(_t(a) for a in draws))
    b = _t(batch)
    if dp is not None:
        d, b = d.shard(dp), {k: dp.shard(v) for k, v in b.items()}
    metrics = _metrics(step(state, b, 0.9, draws=d), dp)
    moment_elems = sum(_local(s["exp_avg"]).numel() for s in state.optimizer.adam.state.values())
    param_elems = sum(_local(p).numel() for p in unet.parameters())
    full = state.state_dict()
    return {"metrics": metrics, "params": _np(full["params"]), "grads": _grads(unet),
            "optimizer": full["optimizer"], "ema": _np(full.get("ema_params", {})),
            "step": state.step, "moment_elems": moment_elems, "param_elems": param_elems}


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _sched(cfg):
    from ldm3d_torch.diffusion import DDPMScheduler

    return DDPMScheduler.create(num_train_timesteps=cfg["NoiseScheduler"]["num_train_timesteps"])


def stage2_full_step(cfg, ae_sd, u_sd, batch, lr, seed, one_process=False):
    """One ``make_stage2_train_step`` step (the VAE encode inside), its draws
    from a generator seeded ``seed`` (the global batch's, sharded)."""
    dp = None if one_process else DataParallel.current()
    ae = _model(cfg, "autoencoder_def", ae_sd).eval().requires_grad_(False)
    unet = _model(cfg, "diffusion_def", u_sd)
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda _: lr, dp=dp))
    step = make_stage2_train_step(unet, ae, _sched(cfg), Stage2Config(), dp=dp)
    b = _t(batch)
    if dp is not None:
        b = {k: dp.shard(v) for k, v in b.items()}
    gen = torch.Generator().manual_seed(seed)
    metrics = _metrics(step(state, b, 0.9, gen), dp)
    return {"metrics": metrics, "params": _np(state.state_dict()["params"]),
            "grads": _grads(unet)}


def stage1_step(cfg, g_sd, d_sd, d_channels, images, draws, lr, adv_active, mode="ddp",
                one_process=False):
    """One adversarial-or-not stage-1 step (no LPIPS) with the global
    batch's draws (eps of the global batch)."""
    from ldm3d_torch.nn import PatchDiscriminator3D

    dp = None if one_process else DataParallel.current()
    ae = _model(cfg, "autoencoder_def", g_sd)
    disc = PatchDiscriminator3D(num_layers_d=3, channels=d_channels)
    disc.load_state_dict(_t(d_sd))
    g_state = TrainState(ae, make_optimizer(ae.parameters(), lambda _: lr, dp=dp))
    d_state = TrainState(disc, make_optimizer(disc.parameters(), lambda _: lr, dp=dp))
    if dp is not None:
        _shard(g_state, mode, dp)
        _shard(d_state, mode, dp)
    tcfg = cfg["autoencoder_train"]
    step = make_stage1_train_step(ae, disc, None, Stage1Config(
        kl_weight=tcfg["kl_weight"], perceptual_weight=0.0), dp=dp)
    x, d = _t(images), Stage1Draws(_t(draws))
    if dp is not None:
        x, d = dp.shard(x), Stage1Draws(dp.shard(d.eps))
    metrics = _metrics(step(g_state, d_state, x, adv_active, draws=d), dp)
    return {"metrics": metrics, "g": _np(g_state.state_dict()["params"]),
            "d": _np(d_state.state_dict()["params"]), "g_grads": _grads(ae),
            "d_grads": _grads(disc)}


def distill_step(cfg, ae_sd, u_sd, batch, draws, lr, n_train, teacher_steps, scale,
                 one_process=False):
    """One progressive-distillation step on the global batch's draws."""
    from ldm3d_torch.diffusion import DDPMScheduler

    dp = None if one_process else DataParallel.current()
    ae = _model(cfg, "autoencoder_def", ae_sd).eval().requires_grad_(False)
    teacher = _model(cfg, "diffusion_def", u_sd).requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True).train()
    state = TrainState(student, make_diffusion_optimizer(student.parameters(), lambda _: lr,
                                                         dp=dp))
    step = make_distillation_step(teacher, ae, DDPMScheduler.create(num_train_timesteps=n_train),
                                  DistillConfig(teacher_steps=teacher_steps), dp=dp)
    b, d = _t(batch), DistillDraws(*(_t(a) for a in draws))
    if dp is not None:
        b, d = {k: dp.shard(v) for k, v in b.items()}, d.shard(dp)
    metrics = _metrics(step(state, teacher, b, scale, draws=d), dp)
    return {"metrics": metrics, "params": _np(state.state_dict()["params"]),
            "grads": _grads(student)}


@contextlib.contextmanager
def without_tensorflow():
    """TensorFlow kept out of this process inside the block: tensorboard's
    writer (which the trainers' ``MetricsWriter`` wraps) then takes its own
    stub, and a process saves the ~15 s TensorFlow's import costs here. No
    port code uses TensorFlow; an import of it already made is left alone."""
    added = "tensorflow" not in sys.modules
    if added:
        sys.modules["tensorflow"] = None
    try:
        yield
    finally:
        if added and sys.modules.get("tensorflow", 0) is None:
            del sys.modules["tensorflow"]


def run_cli(module: str, argv: list, stop_rank: int = -1, stop_poll: int = 0):
    """``main(argv)`` of ``ldm3d_torch.cli.<module>`` on this rank, the
    shutdown latched on rank ``stop_rank``'s ``stop_poll``-th poll, with
    TensorFlow kept out of the rank process (:func:`without_tensorflow`)."""
    import importlib

    sys.modules.setdefault("tensorflow", None)

    from ldm3d_torch.parallel import rank
    from ldm3d_torch.training import GracefulShutdown

    cli = importlib.import_module(f"ldm3d_torch.cli.{module}")

    class _StopOnPoll(GracefulShutdown):
        polls = 0

        @property
        def requested(self) -> bool:
            self.polls += 1
            if rank() == stop_rank and self.polls == stop_poll:
                self.trigger()
            return self._flag.is_set()

    before = getattr(cli, "GracefulShutdown", None)
    if before is not None:
        cli.GracefulShutdown = _StopOnPoll
    try:
        timings: dict = {}
        return cli.main(argv, timings=timings), timings
    finally:
        if before is not None:
            cli.GracefulShutdown = before


def raise_on_rank_one():
    """Rank 1 raises; rank 0 waits in an all-reduce for it (never answered)."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise KeyError("rank one")
    t = torch.zeros(1)
    dist.all_reduce(t)
    return 0


def sleep(seconds: float) -> None:
    import time

    time.sleep(seconds)
