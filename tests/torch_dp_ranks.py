"""Rank-side functions of the port's data-parallel tests (no JAX here).

Each runs on every rank of a :class:`ldm3d_torch.parallel.launch.RankPool`
(the default process group up, gloo on the CPU), or in the test process
itself with ``dp=None`` for the one-process reference. Models come from a
config dict and state_dicts of numpy arrays, batches and draws as numpy
arrays of the GLOBAL batch: each rank takes its rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


# --- depth sharding (``--spatial``) --------------------------------------------


def _spatial(spatial: int = 2):
    """This rank's spatial group of the ``data x spatial`` layout."""
    from ldm3d_torch.parallel import MeshSpec, set_layout
    from ldm3d_torch.parallel.spatial import SpatialGroup

    set_layout(MeshSpec(spatial=spatial))
    return SpatialGroup.current()


def _slab(x, sg, dim: int = 1):
    from ldm3d_torch.parallel.spatial import shard_volume

    return shard_volume(x, sg, dim)


def spatial_halo(x, w, lo: int, hi: int, dim: int = 2) -> dict:
    """``halo_exchange`` of this rank's depth slab of ``x`` (NCDHW), and the
    gradient of ``sum(out * w[rank])`` reaching the slab."""
    from ldm3d_torch.parallel.spatial import halo_exchange

    sg = _spatial()
    xs = _slab(_t(x), sg, dim).clone().requires_grad_(True)
    out = halo_exchange(xs, sg, lo, hi, dim)
    (out * _t(w[sg.index])).sum().backward()
    return {"out": out.detach().numpy(), "dx": xs.grad.numpy(),
            "cl_strides": _cl_strides(halo_exchange(
                xs.detach().contiguous(memory_format=torch.channels_last_3d), sg, lo, hi, dim))}


def _cl_strides(t: torch.Tensor) -> bool:
    """Whether ``t`` has the exact strides of channels_last_3d (a
    one-channel tensor's too)."""
    return t.stride() == torch.empty(t.shape, memory_format=torch.channels_last_3d).stride()


def spatial_block(kind: str, kwargs: dict, sd: dict, x, dy) -> dict:
    """One block of ``ldm3d_torch.nn.blocks`` bound to the spatial group on
    this rank's depth slab of ``x`` (NCDHW, channels_last_3d): its output
    slab, the gradient of ``sum(y * dy)`` at the slab, and its parameters'
    gradients from this slab (the test sums them over the ranks)."""
    from ldm3d_torch.nn import blocks
    from ldm3d_torch.parallel.spatial import spatial_clone

    sg = _spatial()
    block = getattr(blocks, kind)(**kwargs)
    block.load_state_dict(_t(sd))
    block = spatial_clone(block, sg)
    xs = _slab(_t(x), sg, 2).contiguous(memory_format=torch.channels_last_3d)
    xs.requires_grad_(True)
    y = block(xs)
    (y * _slab(_t(dy), sg, 2)).sum().backward()
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(),
            "grads": {n: p.grad.numpy() for n, p in block.named_parameters()}}


def spatial_attention(q, k, v, do) -> dict:
    """``volumetric_attention`` of this rank's query tokens against every
    slab's keys and values (``gather_tokens``); the output and the q, k, v
    gradients of ``sum(out * do)`` at this rank's slabs."""
    from ldm3d_torch.ops.attention import volumetric_attention
    from ldm3d_torch.parallel.spatial import gather_tokens

    sg = _spatial()
    qs, ks, vs = (_slab(_t(a), sg).clone().requires_grad_(True) for a in (q, k, v))
    out = volumetric_attention(qs, gather_tokens(ks, sg), gather_tokens(vs, sg))
    (out * _slab(_t(do), sg)).sum().backward()
    return {"out": out.detach().numpy(), "dq": qs.grad.numpy(), "dk": ks.grad.numpy(),
            "dv": vs.grad.numpy()}


def spatial_models(cfg, ae_sd, u_sd, x, eps, z, t) -> dict:
    """The VAE's ``encode_stage_2_inputs`` and the UNet's forward, each
    bound to the spatial group, on this rank's slabs (NDHWC)."""
    from ldm3d_torch.parallel.spatial import make_spatial_encoder, spatial_clone

    sg = _spatial()
    ae = _model(cfg, "autoencoder_def", ae_sd).eval()
    unet = spatial_clone(_model(cfg, "diffusion_def", u_sd), sg)
    with torch.no_grad():
        enc = make_spatial_encoder(ae, sg)(_slab(_t(x), sg), _slab(_t(eps), sg))
        pred = unet(_slab(_t(z), sg), _t(t))
    return {"encode": enc.numpy(), "unet": pred.numpy()}


def _spatial_parts(cfg, ae_sd, u_sd, spatial: int):
    from ldm3d_torch.parallel.spatial import SpatialGroup

    sg = _spatial(spatial) if spatial > 1 else None
    dp = DataParallel.current() if spatial > 1 else None
    ae = _model(cfg, "autoencoder_def", ae_sd).eval().requires_grad_(False)
    unet = _model(cfg, "diffusion_def", u_sd)
    assert sg is None or isinstance(sg, SpatialGroup)
    return sg, dp, ae, unet


def _cut(batch: dict, dp, sg) -> dict:
    b = _t(batch)
    if sg is None:
        return b
    return {k: _slab(dp.shard(v), sg).contiguous() for k, v in b.items()}


def _one_process_draws(ae, sched, batch: dict, s2cfg, gen, dropout: bool):
    """The draws the one-process step makes from ``gen`` (drawn here so the
    caller can hand them to a reference too)."""
    from ldm3d_torch.training import draw_stage2

    f = ae.downsample_factor
    labels = batch["label"]
    shape = (labels.shape[0], *[s // f for s in labels.shape[1:4]], ae.latent_channels)
    return draw_stage2(gen, shape, sched.num_train_timesteps, s2cfg, labels.device,
                       dropout=dropout)


def _np_draws(draws) -> list | None:
    return None if draws is None else [None if t is None else t.numpy()
                                       for t in dataclasses.astuple(draws)]


def spatial_stage2_step(cfg, ae_sd, u_sd, batch, lr, seed, cfg_kwargs=None,
                        spatial: int = 2) -> dict:
    """One stage-2 step (the VAE encode inside) on the global ``batch``,
    its draws from a generator seeded ``seed``: the spatial step on this
    rank's rows and slabs (``spatial > 1``), else the one-process step,
    which also returns its draws (``Stage2Draws`` fields as numpy)."""
    sg, dp, ae, unet = _spatial_parts(cfg, ae_sd, u_sd, spatial)
    s2cfg = Stage2Config(**(cfg_kwargs or {}))
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda _: lr, dp=dp))
    sched = _sched(cfg)
    step = make_stage2_train_step(unet, ae, sched, s2cfg, dp=dp, sg=sg)
    gen, b = torch.Generator().manual_seed(seed), _cut(batch, dp, sg)
    draws = None if sg is not None else _one_process_draws(ae, sched, b, s2cfg, gen, True)
    metrics = _metrics(step(state, b, 0.9, gen, draws=draws), dp)
    return {"metrics": metrics, "params": _np(state.state_dict()["params"]),
            "grads": _grads(unet), "draws": _np_draws(draws)}


def spatial_stage2_eval(cfg, ae_sd, u_sd, batch, seed, spatial: int = 2) -> dict:
    """The stage-2 eval step's loss (the spatial one with ``spatial > 1``),
    its draws from a generator seeded ``seed`` (the one-process step's
    returned too, as in :func:`spatial_stage2_step`)."""
    from ldm3d_torch.training import make_stage2_eval_step

    sg, dp, ae, unet = _spatial_parts(cfg, ae_sd, u_sd, spatial)
    sched = _sched(cfg)
    step = make_stage2_eval_step(unet, ae, sched, Stage2Config(), dp=dp, sg=sg)
    gen, b = torch.Generator().manual_seed(seed), _cut(batch, dp, sg)
    draws = (None if sg is not None
             else _one_process_draws(ae, sched, b, Stage2Config(), gen, False))
    loss = step(b, 0.9, gen, draws=draws)["val_diffusion_loss"]
    return {"loss": float(loss if dp is None else dp.mean(loss)), "draws": _np_draws(draws)}


def spatial_sample(cfg, ae_sd, u_sd, sampler: str, steps: int, noise, cond, seed: int,
                   scale: float, spatial: int = 2):
    """A sample (the reverse loop, ``/ scale`` and the decode) from the
    global ``noise`` and ``cond``: the spatial sampler's slabs gathered
    (``spatial > 1``), else the one-process sample."""
    from ldm3d_torch.cli.common import make_sampling_scheduler
    from ldm3d_torch.diffusion import inferer
    from ldm3d_torch.parallel.spatial import make_spatial_sampler

    sg, dp, ae, unet = _spatial_parts(cfg, ae_sd, u_sd, spatial)
    sched = make_sampling_scheduler(sampler, steps, {
        "num_train_timesteps": cfg["NoiseScheduler"]["num_train_timesteps"],
        "beta_start": cfg["NoiseScheduler"]["beta_start"],
        "beta_end": cfg["NoiseScheduler"]["beta_end"], "prediction_type": "epsilon"})
    gen = torch.Generator().manual_seed(seed)
    noise, cond = _t(noise), _t(cond)
    with torch.no_grad():
        if sg is None:
            return inferer.sample(unet, ae.decode_stage_2_outputs, sched, noise, cond,
                                  scale_factor=scale, generator=gen).numpy()
        run = make_spatial_sampler(unet, ae, sched, sg, scale_factor=scale, dp=dp)
        return sg.all_gather(run(_slab(noise, sg), _slab(cond, sg), gen), 1).numpy()
