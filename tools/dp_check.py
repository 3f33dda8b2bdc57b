"""Data-parallel checks of the training steps on ranks of a RankPool.

The rank-side half of ``chip_smoke.py``'s parallel phase (and of the
``cuda`` tests in ``tests/test_torch_dp_card.py``): each function runs on
every rank of a :class:`ldm3d_torch.parallel.launch.RankPool`, rank 0 first
computing the one-process reference where one is needed.

* :func:`grads_check`: a stage-2 or stage-1 step at ``global_batch / world``
  a rank against the one-process step at ``global_batch`` on the same draws.
  The gradients are read where each rank computed them and where the
  optimizer receives them after the ranks' mean (``ClippedAdam._reduce_grads``
  and ``_clip``; the clip and update skipped); their distance from the
  reference over its largest |g| is returned, and that of the gradients
  three faulty programs would hold, formed from the same run: each rank's
  own gradient (the all-reduce skipped), rank 0's gradient (every rank
  averaging rank 0's rows: a rank that took the other's slice), the ranks'
  sum (not averaged). Each fault must read far above the limit.
* with ``zero=True`` (stage 2) the plain run also applies its update, the
  plain step runs once more, and one fp32 ZeRO-1 step from the same weights
  follows. Each update (the step's params less the weights it started from)
  is held against the plain step's, over the largest plain |update|: the
  repeat reads the card's run-to-run spread, ZeRO-1 reads its own, and a
  ZeRO-1 that never puts the ranks' slices back together (each rank's
  params stale outside its own slices), formed from the same run, must
  read far above both.
* :func:`timed_steps`: launch counts of one data-parallel step per rank
  against the one-process step at the per-rank batch, then the mean of
  ``steps`` timed steps (wall clock between barriers).
* :func:`spatial_check`: depth sharding (``--spatial``) on the ranks laid
  out as one data replica of ``world`` depth slabs: the fp32 spatial
  stage-2 step's gradients, summed over the slabs, against the one-process
  step's on the same draws (and the gradient a faulty program would hold,
  formed from the same run: each rank's own slab's gradient, the sum
  skipped); a bf16 spatial step's launches by route against the
  one-process step's, then a second step timed; the attention and
  GroupNorm inputs each run gave the kernels, and the spatial collectives'
  and the gradient all-reduce's bytes and seconds.
* :func:`cli_cases`: a CLI run on this rank (``cli.inference -g 2
  --spatial 2``, say) with the launches it made and the attention and
  GroupNorm inputs it gave the kernels.
* :func:`fsdp_world1`: one step under ``fully_shard`` over a one-rank group
  (:func:`ldm3d_torch.parallel.launch.group_of_one`) against the unwrapped
  step (launch counts), and its full-state checkpoint loaded into a
  one-process state, bit for bit.

Models are a config's VAE and UNet (and stage 1's discriminator and LPIPS)
with seeded weights made on the device, the same on every rank; volumes and
draws come from seeded CPU generators, so every rank holds the same global
batch and keeps its rows. ``device`` is the ranks' device type (``cuda`` on
the card; ``cpu`` rehearses the same checks on a small preset).
"""

from __future__ import annotations

import contextlib
import functools
import math
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from ldm3d_torch.configs import define_instance, load_json, preset_path
from ldm3d_torch.ops.graphs import launch_counts, launch_delta
from ldm3d_torch.parallel import DataParallel
from ldm3d_torch.training import state as state_mod

# the faulty programs the check must see: every rank keeping its own
# gradient (the all-reduce skipped), every rank training on rank 0's rows (a
# rank taking the other's slice), the ranks' gradients summed, not averaged
FAULTS = ("skip_all_reduce", "other_slice", "sum")
# the ZeRO-1 check holds the updates at least this share of the largest
HELD = 0.9


def _cfg(preset: str) -> SimpleNamespace:
    return SimpleNamespace(**load_json(preset_path(preset)))


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


@functools.lru_cache(maxsize=2)
def _preset_models(preset: str, device: str):
    """:func:`_models` of a preset, built once a process (the checks that
    follow each other on a rank share them, their weights reloaded as each
    needs)."""
    return _models(_cfg(preset), torch.float32, device)


def _models(ns, dtype, device: str, seed: int = 1):
    """The config's VAE and UNet, seeded on the device; the UNet's zero-init
    output conv drawn so that every layer reaches the output."""
    from ldm3d_torch.nn import init_weights_

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    w = unet.conv_out.weight
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
    ae.compute_dtype = unet.compute_dtype = dtype
    return ae.eval().requires_grad_(False), unet


@contextlib.contextmanager
def _recorded_grads(local: list, averaged: list, update: bool = False):
    """Every optimizer's gradients as each rank computed them (``local``,
    before the ranks' mean) and as the clip receives them (``averaged``),
    flattened; without ``update`` no clip and no Adam step follow."""
    reduce = state_mod.ClippedAdam._reduce_grads
    clip, adam_step = state_mod.ClippedAdam._clip, state_mod.ClippedAdam._adam_step

    def record_reduce(self, grads):
        local.extend(t.detach().float().reshape(-1).clone() for t in grads)
        reduce(self, grads)

    def record(self, tensors):
        averaged.extend(t.detach().float().reshape(-1).clone() for t in tensors)
        return clip(self, tensors) if update else state_mod.global_norm(tensors)

    state_mod.ClippedAdam._reduce_grads = record_reduce
    state_mod.ClippedAdam._clip = record
    if not update:
        state_mod.ClippedAdam._adam_step = lambda self, count: None
    try:
        yield
    finally:
        state_mod.ClippedAdam._reduce_grads = reduce
        state_mod.ClippedAdam._clip, state_mod.ClippedAdam._adam_step = clip, adam_step


def _batch(ns, stage: int, global_batch: int, seed: int, ae_patch: int = 64):
    """Seeded CPU volumes of the global batch: stage 2's (image, label) at
    its patch, or stage 1's images at ``ae_patch``^3."""
    patch = ns.diffusion_train["patch_size"] if stage == 2 else [ae_patch] * 3
    gen = torch.Generator().manual_seed(seed)
    shape = (global_batch, *patch, ns.image_channels)
    return {k: torch.rand(shape, generator=gen) for k in (("image", "label") if stage == 2
                                                          else ("image",))}


def _stage2_step(ns, ae, unet, dp, dtype):
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.training import (
        Stage2Config,
        TrainState,
        make_diffusion_optimizer,
        make_stage2_train_step,
    )

    sched = DDPMScheduler.create(num_train_timesteps=ns.NoiseScheduler["num_train_timesteps"])
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda _: 1e-4, dp=dp))
    return state, make_stage2_train_step(unet, ae, sched, Stage2Config(), dp=dp)


def _run_stage2(ns, ae, unet, batch, dp, dtype, seed, device, zero=False):
    """One stage-2 step on ``batch`` (global; this rank's rows under ``dp``)
    with draws from a CPU generator seeded ``seed``."""
    state, step = _stage2_step(ns, ae, unet, dp, dtype)
    if zero:
        from ldm3d_torch.parallel.zero import shard_train_state_zero

        shard_train_state_zero(state, dp)
    b = {k: (dp.shard(v) if dp is not None else v).to(device) for k, v in batch.items()}
    return state, step(state, b, 0.8, torch.Generator().manual_seed(seed))


def _run_stage1(ns, parts, images, dp, seed, device):
    from ldm3d_torch.training import Stage1Config, TrainState, make_optimizer, make_stage1_train_step

    ae, disc, lpips = parts
    tcfg = ns.autoencoder_train
    g = TrainState(ae, make_optimizer(ae.parameters(), lambda _: 1e-4, dp=dp))
    d = TrainState(disc, make_optimizer(disc.parameters(), lambda _: 1e-4, dp=dp))
    step = make_stage1_train_step(ae, disc, lpips, Stage1Config(
        kl_weight=tcfg["kl_weight"], perceptual_weight=tcfg.get("perceptual_weight", 0.0)),
        dp=dp)
    x = (dp.shard(images) if dp is not None else images).to(device)
    return step(g, d, x, True, torch.Generator().manual_seed(seed))


def _stage1_parts(ns, dtype, device: str):
    from ldm3d_torch.cli.train_autoencoder import build_discriminator
    from ldm3d_torch.nn import LPIPS, init_lpips_, init_weights_

    gen = torch.Generator(device=device).manual_seed(3)
    with torch.device(device):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        disc = init_weights_(build_discriminator(ns), gen)
    lpips = init_lpips_(LPIPS(compute_dtype=dtype)).to(device).eval().requires_grad_(False)
    ae.compute_dtype = disc.compute_dtype = dtype
    return ae.train(), disc.train(), lpips


def grads_check(preset: str, stage: int, global_batch: int, faults: bool = True,
                seed: int = 7, device: str = "cuda", ae_patch: int = 64,
                zero: bool = False) -> dict:
    """The distance of this rank's averaged gradients from the one-process
    gradients at ``global_batch`` (fp32, TF32 off), over the reference's
    largest |g| (``"ddp"``), and with ``faults`` those of the three faulty
    programs (:data:`FAULTS`); ``"seconds"`` of each part.
    With ``zero`` (stage 2) the plain run also applies its update, then
    ``"repeat"``, ``"zero"`` and ``"zero_no_gather"`` are the distances of
    a second plain step's update, a ZeRO-1 step's and that of a ZeRO-1 that
    skips its gather from the plain step's, over its largest |update|."""
    from ldm3d_torch.cli.common import tf32_flags

    ns, dp = _cfg(preset), DataParallel.current()
    dtype = torch.float32
    if stage == 2:
        ae, unet = _preset_models(preset, device)
        ae.compute_dtype = unet.compute_dtype = dtype
        init = {k: v.clone() for k, v in unet.state_dict().items()}
        batch = _batch(ns, 2, global_batch, seed)

        def run(dp_, zero_=False):
            unet.load_state_dict(init)
            _run_stage2(ns, ae, unet, batch, dp_, dtype, seed, device, zero=zero_)
    else:
        parts = _stage1_parts(ns, dtype, device)
        init = [{k: v.clone() for k, v in m.state_dict().items()} for m in parts[:2]]
        images = _batch(ns, 1, global_batch, seed, ae_patch)["image"]

        def run(dp_, zero_=False):
            for m, sd in zip(parts[:2], init):
                m.load_state_dict(sd)
            _run_stage1(ns, parts, images, dp_, seed, device)

    out = {}
    times = out["seconds"] = {}
    t0 = time.perf_counter()
    with tf32_flags(False):
        if dp.rank == 0:
            ref: list = []
            with _recorded_grads([], ref):
                run(None)
            ref_flat = torch.cat(ref)
            del ref
            if device == "cuda":
                torch.cuda.empty_cache()
        else:
            n = sum(p.numel() for p in (unet.parameters() if stage == 2 else
                                        [*parts[0].parameters(), *parts[1].parameters()])
                    if p.requires_grad)
            ref_flat = torch.empty(n, device=device)
        times["reference"] = time.perf_counter() - t0
        dist.broadcast(ref_flat, 0)
        top = ref_flat.abs().max()
        times["broadcast"] = time.perf_counter() - t0 - times["reference"]

        def err(g: torch.Tensor) -> float:
            return float((g - ref_flat).abs().max() / top)

        t_run = time.perf_counter()
        local, averaged = [], []
        with _recorded_grads(local, averaged, update=zero):
            run(dp)
        local, averaged = torch.cat(local), torch.cat(averaged)
        out["ddp"] = err(averaged)
        times["ddp"] = time.perf_counter() - t_run
        if faults:  # what each faulty program would hold, from this run's gradients
            out["skip_all_reduce"] = err(local)  # each rank keeps its own gradient
            out["sum"] = err(averaged * dp.world)  # summed, not averaged
            # a rank that takes rank 0's rows: every rank averages rank 0's gradient
            other = torch.tensor([err(local) if dp.rank == 0 else 0.0], dtype=torch.float64,
                                 device=device)
            dist.broadcast(other, 0)
            out["other_slice"] = float(other.item())
        del local, averaged
        if zero:
            t_run = time.perf_counter()
            out.update(_zero_update_errs(unet, init, lambda z: run(dp, zero_=z), dp))
            times["zero"] = time.perf_counter() - t_run
    for model in ((unet,) if stage == 2 else parts[:2]):
        model.zero_grad(set_to_none=True)
    return out


def _updates(model, init: dict) -> dict:
    return {n: p.detach() - init[n] for n, p in model.named_parameters()}


def _zero_update_errs(unet, init: dict, run, dp) -> dict:
    """The updates of a second plain step, a ZeRO-1 step and a ZeRO-1 step
    without its gather against the plain step's update (already applied to
    ``unet``), over its largest |update| (about lr), on the elements whose
    plain update is at least ``HELD`` of that: there |g| is at least 9 times
    Adam's eps, and the first update, -lr g / (|g| + eps), hardly moves with
    the card's run-to-run spread of g. The gather-less step's params are
    the ZeRO-1 step's on this rank's slices and the start's elsewhere."""
    from ldm3d_torch.parallel.zero import zero_spec_for

    plain = _updates(unet, init)
    top = max(float(u.abs().max()) for u in plain.values())
    held = {n: u.abs() >= HELD * top for n, u in plain.items()}

    def err(updates: dict) -> float:
        diffs = [(updates[n] - plain[n])[held[n]].abs() for n in plain]
        return max(float(d.max()) for d in diffs if d.numel()) / top

    out = {"held_share": sum(int(h.sum()) for h in held.values())
           / sum(h.numel() for h in held.values())}
    run(False)
    out["repeat"] = err(_updates(unet, init))
    run(True)
    got = _updates(unet, init)
    out["zero"] = err(got)
    for n, u in got.items():
        d = zero_spec_for(u.shape, dp.world)
        if d is not None:
            per = u.shape[d] // dp.world
            stale = torch.zeros_like(u)
            stale.narrow(d, dp.rank * per, per).copy_(u.narrow(d, dp.rank * per, per))
            got[n] = stale
    out["zero_no_gather"] = err(got)
    return out


def _counts_of(fn, device: str) -> dict:
    before = launch_counts()
    fn()
    _sync(device)
    return launch_delta(launch_counts(), before)


def timed_steps(preset: str, global_batch: int, steps: int = 3, seed: int = 13,
                device: str = "cuda") -> dict:
    """bf16 stage-2 data-parallel steps: the launch counts of one step on
    this rank and (rank 0) of the one-process step at the per-rank batch,
    then the mean wall time of ``steps`` steps between barriers."""
    ns, dp = _cfg(preset), DataParallel.current()
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    ae, unet = _preset_models(preset, device)
    ae.compute_dtype = unet.compute_dtype = dtype
    b = {k: dp.shard(v).to(device) for k, v in _batch(ns, 2, global_batch, seed).items()}
    gen = torch.Generator().manual_seed(seed)
    one = None
    if dp.rank == 0:  # the one-process step at this rank's batch, from the same weights
        init = {k: v.clone() for k, v in unet.state_dict().items()}
        s1, step1 = _stage2_step(ns, ae, unet, None, dtype)
        one = _counts_of(lambda: step1(s1, b, 0.8, torch.Generator().manual_seed(seed)), device)
        del s1
        unet.load_state_dict(init)
    state, step = _stage2_step(ns, ae, unet, dp, dtype)
    dist.barrier()
    mine = _counts_of(lambda: step(state, b, 0.8, gen), device)  # also the warm-up step
    dist.barrier()
    _sync(device)
    t0 = time.perf_counter()
    before = launch_counts()
    for _ in range(steps):
        step(state, b, 0.8, gen)
    _sync(device)
    dist.barrier()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"step_counts": mine, "one_process_counts": one, "ms_per_step": ms,
            "timed_counts": launch_delta(launch_counts(), before),
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
                         else None)}


def fsdp_world1(preset: str, batch: int, model_dir: str, seed: int = 17,
                device: str = "cuda") -> dict:
    """One bf16 stage-2 step under ``fully_shard`` over this one-rank group
    against the unwrapped step from the same weights (launch counts); then
    its full-state checkpoint written and loaded into a one-process state."""
    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.parallel.fsdp import shard_train_state_fsdp

    ns = _cfg(preset)
    times, t0 = {}, time.perf_counter()
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    ae, unet = _models(ns, dtype, device)
    init = {k: v.clone() for k, v in unet.state_dict().items()}
    b = {k: v.to(device) for k, v in _batch(ns, 2, batch, seed).items()}
    state, step = _stage2_step(ns, ae, unet, None, dtype)
    plain = _counts_of(lambda: step(state, b, 0.8, torch.Generator().manual_seed(seed)), device)
    del state
    with torch.device(device):
        unet2 = define_instance(ns, "diffusion_def")
    unet2.load_state_dict(init)
    unet2.compute_dtype = dtype
    dp1 = DataParallel(1, 0)
    state2, step2 = _stage2_step(ns, ae, unet2, dp1, dtype)
    shard_train_state_fsdp(state2, dp1)
    metrics = {}
    sharded = _counts_of(lambda: metrics.update(step2(state2, b, 0.8,
                                                      torch.Generator().manual_seed(seed))),
                         device)
    times["steps"] = time.perf_counter() - t0
    full = state2.state_dict()
    ckpt = CheckpointManager(model_dir, "diffusion")
    ckpt.save("last", full, {"epoch": 0})
    times["save"] = time.perf_counter() - t0 - times["steps"]
    loaded = ckpt.load("last", map_location=device)
    with torch.device(device):  # its own initial weights, overwritten by the load
        unet3 = define_instance(ns, "diffusion_def")
    state3, _ = _stage2_step(ns, ae, unet3, None, dtype)
    state3.load_state_dict(loaded)
    again = state3.state_dict()
    equal = (all(torch.equal(again["params"][k], v) for k, v in full["params"].items())
             and again["step"] == full["step"] == 1
             and all(torch.equal(again["optimizer"]["state"][i][m], e[m])
                     for i, e in full["optimizer"]["state"].items()
                     for m in ("exp_avg", "exp_avg_sq")))
    times["load_and_compare"] = time.perf_counter() - t0 - times["steps"] - times["save"]
    return {"plain_counts": plain, "fsdp_counts": sharded, "checkpoint_bit_equal": equal,
            "seconds": times,
            "loss": float(metrics["diffusion_loss"]),
            "sharded_params": sum(hasattr(p, "to_local") for p in unet2.parameters())}


def _cases() -> dict:
    """The attention and GroupNorm wrappers' launches by input since the last
    :func:`_clear_cases`."""
    from ldm3d_torch.ops import attention as A
    from ldm3d_torch.ops import groupnorm as G

    return {"attn_fwd": dict(A.flash_attention_fwd.cases),
            "attn_bwd": dict(A.flash_attention_bwd_dq.cases),
            "gn_sums": dict(G.gn_sums.cases), "gn_bwd_sums": dict(G.gn_bwd_sums.cases)}


def _clear_cases() -> None:
    from ldm3d_torch.ops import attention as A
    from ldm3d_torch.ops import groupnorm as G

    for fn in (A.flash_attention_fwd, A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv,
               G.gn_sums, G.gn_bwd_sums):
        fn.cases = {}


@contextlib.contextmanager
def _transfers(readings: dict, device: str):
    """Calls, bytes and wall seconds (to a device sync on both sides) of
    every spatial collective and of the gradient all-reduce inside the
    block, by kind; under time-sharing a collective's seconds include its
    wait for the other rank."""
    from ldm3d_torch.parallel import mesh
    from ldm3d_torch.parallel import spatial as S

    def nbytes(ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    sizes = {
        (S.SpatialGroup, "exchange"): lambda self, sends, recvs: nbytes(
            [t for t, _ in sends] + [b for b, _ in recvs]),
        (S.SpatialGroup, "all_gather"): lambda self, t, dim: nbytes([t]) * self.size,
        (S.SpatialGroup, "reduce_scatter"): lambda self, g, dim: nbytes([g]),
        (S.SpatialGroup, "all_reduce_"): lambda self, t: nbytes([t]),
        (mesh.DataParallel, "all_reduce_mean_"): lambda self, ts: nbytes(ts),
    }
    originals = {key: getattr(*key) for key in sizes}

    def wrap(key, fn, size):
        def run(self, *args):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(self, *args)
            _sync(device)
            r = readings.setdefault(key[1], {"calls": 0, "bytes": 0, "seconds": 0.0})
            r["calls"] += 1
            r["bytes"] += size(self, *args)
            r["seconds"] += time.perf_counter() - t0
            return out
        return run

    for key, size in sizes.items():
        setattr(*key, wrap(key, originals[key], size))
    try:
        yield
    finally:
        for key, fn in originals.items():
            setattr(*key, fn)


def spatial_check(preset: str, global_batch: int = 2, seed: int = 19, device: str = "cuda",
                  scale_factor: float = 0.8) -> dict:
    """Depth sharding over every rank (one data replica, ``world`` slabs):
    see the module docstring. Returns ``"spatial"`` (the fp32 gradients'
    distance from the one-process step's over its largest |g|) and the
    fault's (``"skip_spatial_sum"``), the bf16 launches of this rank's
    first step and (rank 0) the one-process step's, the second step's ms,
    each run's wrapper cases, the transfer readings of the first bf16 step,
    the peak memory and each part's seconds."""
    from ldm3d_torch.cli.common import tf32_flags
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.parallel import MeshSpec, set_layout
    from ldm3d_torch.parallel.spatial import SpatialGroup, shard_volume
    from ldm3d_torch.training import (Stage2Config, TrainState, make_diffusion_optimizer,
                                      make_stage2_train_step)

    _preset_models.cache_clear()  # the data-parallel checks' models
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    set_layout(MeshSpec(spatial=dist.get_world_size()))
    sg, dp = SpatialGroup.current(), DataParallel.current()
    ns = _cfg(preset)
    ae, unet = _preset_models(preset, device)
    init = {k: v.clone() for k, v in unet.state_dict().items()}
    sched = DDPMScheduler.create(num_train_timesteps=ns.NoiseScheduler["num_train_timesteps"])
    batch = _batch(ns, 2, global_batch, seed)
    whole = {k: v.to(device) for k, v in batch.items()}
    slabs = {k: shard_volume(v, sg).contiguous().to(device) for k, v in batch.items()}
    lead = dist.get_rank() == 0
    out: dict = {"cases": {}, "seconds": {}}

    def spatial_state():
        unet.load_state_dict(init)
        state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda _: 1e-4,
                                                          dp=dp))
        return state, make_stage2_train_step(unet, ae, sched, Stage2Config(), dp=dp, sg=sg)

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        out["seconds"][name] = time.perf_counter() - t0
        return result

    def grads_part():
        ae.compute_dtype = unet.compute_dtype = torch.float32
        n = sum(p.numel() for p in unet.parameters() if p.requires_grad)
        if lead:
            ref: list = []
            unet.load_state_dict(init)
            with _recorded_grads([], ref):
                s1, step1 = _stage2_step(ns, ae, unet, None, torch.float32)
                step1(s1, whole, scale_factor, torch.Generator().manual_seed(seed))
            ref_flat = torch.cat(ref)
            del ref, s1
        else:
            ref_flat = torch.empty(n, device=device)
        dist.broadcast(ref_flat, 0)
        top = ref_flat.abs().max()

        def err(g):
            return float((g - ref_flat).abs().max() / top)

        local, averaged = [], []
        state, step = spatial_state()
        _clear_cases()
        with _recorded_grads(local, averaged):
            step(state, slabs, scale_factor, torch.Generator().manual_seed(seed))
        out["cases"]["fp32_step"] = _cases()
        local, averaged = torch.cat(local), torch.cat(averaged)
        out["spatial"] = err(averaged)
        out["skip_spatial_sum"] = err(local)  # each rank keeps its slab's gradient
        unet.zero_grad(set_to_none=True)

    def bf16_part():
        ae.compute_dtype = unet.compute_dtype = torch.bfloat16
        if lead:  # the one-process step on the whole volumes
            unet.load_state_dict(init)
            s1, step1 = _stage2_step(ns, ae, unet, None, torch.bfloat16)
            out["one_process_counts"] = _counts_of(
                lambda: step1(s1, whole, scale_factor, torch.Generator().manual_seed(seed)),
                device)
            del s1
        state, step = spatial_state()
        gen = torch.Generator().manual_seed(seed)
        readings: dict = {}
        _clear_cases()
        dist.barrier()
        with _transfers(readings, device):
            out["step_counts"] = _counts_of(lambda: step(state, slabs, scale_factor, gen),
                                            device)
        out["cases"]["bf16_step"] = _cases()
        out["transfers"] = readings
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        before = launch_counts()
        step(state, slabs, scale_factor, gen)
        _sync(device)
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3
        out["timed_counts"] = launch_delta(launch_counts(), before)
        dist.barrier()
        unet.zero_grad(set_to_none=True)
        del state

    with tf32_flags(False):
        timed("grads_fp32", grads_part)
    timed("bf16_steps", bf16_part)
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None)
    _preset_models.cache_clear()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def cli_cases(module: str, argv: list, device: str = "cuda") -> dict:
    """:func:`cli` on this rank: its result (``"out"``), the launches it
    made (``"counts"``) and the attention and GroupNorm inputs it gave the
    kernels (``"cases"``)."""
    _clear_cases()
    before = launch_counts()
    out = cli(module, argv)
    _sync(device)
    return {"out": out, "counts": launch_delta(launch_counts(), before), "cases": _cases()}


def cli(module: str, argv: list):
    """``ldm3d_torch.cli.<module>.main(argv)`` on this rank."""
    import importlib

    return importlib.import_module(f"ldm3d_torch.cli.{module}").main(argv)
