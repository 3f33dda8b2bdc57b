#!/usr/bin/env python3
"""Drive the PyTorch port (``ldm3d_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and the port's sources; it exits non-zero, without a
result line, when any of them is missing or any phase fails. ``--phases
kernel,kernel_conv`` (any of kernel, kernel_bwd, kernel_c2, kernel_conv,
train_ae, train_ae_fp32, stage1_card_vs_cpu, sample_fused, distill,
distill_card_vs_cpu, evaluate, presets, follow_ups, data_tools, parallel) runs only
those phases after device and build, and prints no result line.
Phases, each printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``ldm3d_torch/csrc`` (one nvcc per
   source, all at once, sm_90a); ``ptxas``'s registers, shared memory and
   spills for each kernel instantiation; fails if an instantiation of the
   tensor-core attention kernels (bf16 forward on mma.sync and on wgmma,
   bf16 backward on wgmma and on mma.sync, the 3xTF32 fp32 forward and
   backward), of the wide (d > 256) attention kernels, of the one-launch
   GroupNorm sums (forward and backward) or of the tensor-core conv spills,
   or if ptxas serializes
   the wgmma of the backward's wgmma kernels;
3. kernel: the flash-attention forward kernel against its plain PyTorch
   version on the card, at the attention shapes of the flagship model
   (``config_train_32g.json``) at 80^3 and 96^3 and at the edge shapes of
   the ``cuda`` tests (every head width instantiation, ragged token counts,
   kv_len != n), at its training shapes (batch 20) and at the stage-1
   patch's (1, 4096, 1, 256), in bf16 (the bf16
   mma.sync route up to d = 128, the wgmma route on TMA-loaded tiles at
   128 < d <= 256) and fp32 (the 3xTF32 tensor-core route), and at
   the head widths and head counts the kernels once refused (d = 36, 320,
   512; batch * heads = 70,000) in both dtypes, on strided views of fused
   projections as the attention block gives them; each row beside SDPA
   (TF32 off), the plain version and the bound, with its route (the
   wrapper's count of that route must rise by one) and the CUDA library's
   launch plan (tensor maps included) held to ``flash_fwd_plan``'s; the bf16
   d = 256 rows also carry the recorded time of the mma.sync kernel the
   wgmma route replaced (``recorded_earlier_ms``, EARLIER_FWD_MS: a recorded
   figure, not measured in this run);
4. kernel_bwd: the flash-attention backward kernels (dQ, dK/dV) against
   their plain versions, at the training shapes, a ragged case, the d = 256
   cases (1, 8000, 1, 256) and stage 1's (1, 4096, 1, 256) and at the edge
   shapes of the ``cuda`` tests (every head width
   instantiation, ragged token counts, kv_len != n, the training shapes at
   batch 2), in bf16 (the wgmma route on TMA-loaded tiles up to d = 128,
   the mma.sync route above) and fp32 (the 3xTF32 tensor-core route), and
   at the d = 36, 320, 512 and batch * heads = 70,000 cases in both dtypes
   through ``volumetric_attention``'s autograd (kernel_c2 rows); each row
   carries its route (the wrappers' counts of that route must rise) and its
   largest error over its limit, every case gives the same bits on a second
   run, and the CUDA library's launch plans of dQ and dK/dV (tensor maps
   included) are held to ``flash_bwd_plan``'s; ``library_ms`` is the
   backward of ``scaled_dot_product_attention`` (its forward + backward
   less its forward); the fp32 row at (20, 1000, 8, 64) carries the times of
   the scalar kernels the 3xTF32 route replaced beside its own, and the bf16
   rows at d <= 128 the recorded times of the mma.sync pair the wgmma route
   replaced (``recorded_earlier_ms``, EARLIER_BWD_MS: a recorded figure, not
   measured in this run);
5. main path, sampling: conditional DDIM-50 sampling of the full-width
   ``config_train_32g.json`` models (random weights from a seed) through
   ``ldm3d_torch.cli.inference.main`` with ``--amp``, one 80^3 volume; the
   attention kernel's launch count over that run must be exactly 554 (4 of
   them, the VAE's d = 256 attention, on the wgmma route) and
   the GroupNorm-sums kernel's exactly that of the models' GroupNorms (a
   warm-up run comes first); then one more run, DDIM-10, under
   ``torch.profiler`` gives the device time by category and the device's
   idle share;
5b. sample_fused: ``cli.inference --fused-decode`` (the reverse loop and the
   decode replayed as CUDA graphs) on the same full-width checkpoints: DDIM-50
   bf16 batch 1; ddpm strided to 50 steps, fp32, batch 2, guidance 2.0;
   dpm3-20 bf16; ddpm over a full schedule (stride 1: the ``betas[t]``
   rows, which no strided run reaches), bf16, on a copy of the config whose
   schedule has FULL_SCHEDULE_STEPS (100) steps, not 1,000; each held bit
   for bit to its eager twin (the same argv and seed), its launches a sample
   equal to the twin's (warm-up taken off) and to those the sampler implies,
   the graphs captured once a run (however many steps), the replay loop
   under ``set_sync_debug_mode("error")``; capture ms, device ms a step and
   of the decode, volumes/s and peak memory beside the twin's; then one fused
   DDIM-10 sample profiled;
6. main path, training: ``ldm3d_torch.cli.train_diffusion.main`` with
   ``--amp --no-images`` on synthetic 80^3 pairs, batch 20, one epoch of 4
   steps (the first a warm-up) and one validation pass; finite losses, the
   diffusion ``best``/``last`` checkpoints written and reloaded, and the
   exact launch count of each of the five kernels (every backward launch,
   11 dQ and 11 dK/dV a step, on the bf16 wgmma route); then one step under
   ``torch.profiler``;
6b. main path, fp32 training: the same run without ``--amp`` (the CLI's
   default): fp32 throughout, so the attention backward takes the 3xTF32
   route; the same checks and launch counts, and one step profiled;
6c. main path, stage-1 training: ``ldm3d_torch.cli.train_autoencoder.main``
   with ``--amp --no-images`` on the full-width ``config_train_32g.json``
   autoencoder, the CLI's discriminator (3 layers, 32 channels) and LPIPS,
   at the preset's batch 1 and 64^3 crop of synthetic 80^3 pairs, through a
   copy of the preset with warmup_epochs 0, val_interval 1 and 2 epochs (a
   warm-up epoch of generator steps, an adversarial epoch of generator and
   discriminator steps, each validated): finite losses, the exact launches
   by route (a step's 4 attention forwards on the wgmma route, 4 dQ and 4
   dK/dV on the bf16 mma.sync route at d = 256, the GroupNorm sums of the
   VAE's GroupNorms and of the discriminator's instance norms), the
   ``autoencoder_best.pt`` it wrote loaded through ``load_frozen_autoencoder``,
   the resumable ``last``; then one adversarial step profiled, with the
   ops' input shapes, which file LPIPS's 2D convolutions apart;
6d. main path, fp32 stage-1 training: the same without ``--amp``: every
   attention launch on the 3xTF32 route;
7. kernel_gn: the GroupNorm voxel-sums kernels (forward and backward sums)
   against their plain versions at every input the main-path runs gave
   them: the wrappers record each launch's (shape, dtype, strides of x and
   dy), and each recorded input is rebuilt with those strides, checked in
   bf16 and fp32 (each kernel also for the same bits on two runs) and
   timed, the backward sums beside ``aten.native_group_norm_backward``
   with one group a (batch, channel) (``library_ms``); the device and host
   times are summed over each path's launches and set beside the recorded
   figures of the kernels each replaced (for B5 EARLIER_GN_BWD_SUMS; not
   measured in this run); gn_host and gn_bwd_host: what each wrapper's host time a call goes
   to, piece by piece;
8. main path, serving: ``ModelServer`` on the full-width
   ``config_train_32g.json`` models (random weights from a seed), 80^3,
   fp32, DDIM-50, batch 2, behind the port's stdlib HTTP server on
   127.0.0.1: two concurrent conditional POST /generate merged by the
   micro-batcher into one batch-2 call, the same request alone twice (the
   batched-vs-alone and same-seed differences, each held to a stated limit),
   a dpm-20 override, a NIfTI output, GET /health, /metrics and /model/info;
   every response 200, a real (not dummy) model, finite 80^3 volumes, the
   echoed sampler and spacing, and the exact attention and GroupNorm-sums
   launches the served calls imply; then one more request (DDIM-10, the
   fewest steps the REST layer takes) under ``torch.profiler`` gives the
   device time by category;
9. kernel_conv: the implicit-GEMM conv kernels (B6 on the tensor cores: bf16
   on wgmma, fp32 on mma.sync in 3xTF32) through their entry point
   ``ldm3d_torch.tools.conv_ab`` at its L0 shapes in bf16 and fp32: held
   against its plain version, timed beside cuDNN, with the recorded time of
   the scalar kernel it replaced (``recorded_earlier_ms``, EARLIER_CONV_MS: a
   recorded figure, not measured in this run), its launch plan held to
   ``conv3d_plan``'s; the untargeted shapes raise on the card too;
10. card against CPU: the ``config_tiny_cpu.json`` sample (as before), one
   ``config_tiny_cpu.json`` train step, and one adversarial stage-1 step (G
   and D, the CLI's discriminator, LPIPS), same weights and draws on the
   card (kernels) and on the CPU (plain), fp32 with TF32 off; the train
   steps hold their losses, their gradients and the updated params;
11. main path, distillation: ``ldm3d_torch.cli.distill.main`` on the seeded
   full-width checkpoints, batch 20 at 80^3: (a) ``--amp``, 8 -> 2 steps in
   2 rounds of 4 steps, a v_prediction student; (b) fp32, 4 -> 2 steps in one
   round of 2 steps with guidance 2.0 distilled (the teacher's guided
   forwards at batch 40). Finite losses, the exact launches a step by kernel
   and route (a stage-2 step's backward and two more UNet forwards), no
   teacher gradient, the distilled meta; then (a)'s student through
   ``cli.inference --use-distilled``, eager and ``--fused-decode`` (equal
   bit for bit), and ``ModelServer(sampler="distilled")``, which answers one
   request and refuses one with guidance; the GroupNorm inputs of both runs
   go to the kernel_gn phase (as the ``distilling_*`` paths), and the kernel
   phase checks the forward at the guided teacher's batch-40 shapes;
12. main path, evaluation: ``ldm3d_torch.cli.evaluate.main`` (fp32, two
   pairs, batch 1) on the distilled student and on DDIM-10, each writing
   its report (seconds a pair, the metrics' share); then SSIM, MS-SSIM and
   the flagship VAE's latent features on seeded 80^3 volumes with both
   ``allow_tf32`` flags True before each call: the same bits as with both
   False, and card against CPU within 1e-5 (the features within 1e-4 of
   their largest |value|);
13. distill_card_vs_cpu: one ``config_tiny_cpu.json`` distillation step on
   the card and on the CPU (same weights and draws, fp32, TF32 off): loss,
   ``grad_norm`` and the student's gradients within 1e-3 relative, the
   updated student within 2 lr + 1e-6.

14. presets: every other bundled model preset (``config_train_16g``,
   ``_multigpu``, ``_stable``, ``_pp``) at its full width and patch, seeded
   random weights: written by ``CheckpointManager``, exported by
   ``cli.export_checkpoint`` (split q/k/v for 16g and stable, fused for
   multigpu and pp), imported into a fresh model_dir by
   ``cli.import_checkpoint`` and held bit-equal (pp's ``mid_depth`` UNet has
   no reference counterpart: its import must be refused at ``mid_stack.0``,
   and its ``best`` comes from the manager); a bf16 DDIM-10 sample through
   ``cli.inference`` from that model_dir (two volumes, the second timed;
   16g unconditional); 3 bf16 stage-2 steps through ``cli.train_diffusion``
   and, but for pp (the flagship's VAE), 3 adversarial bf16 stage-1 steps
   through ``cli.train_autoencoder`` (a copy with warmup_epochs -1), at the
   preset's batch and patch; 16g's two-channel VAE meets one-channel data in
   both CLIs, which refuse it as the JAX CLIs do, so its steps are the
   library's step functions on two-channel volumes (stage 1 without LPIPS,
   which takes 1 or 3 channels). Each run's attention launches by route and
   GroupNorm launches exactly as its models imply; ms a step (the median
   after the first), denoise ms a step, decode ms, peak memory. The kernel
   and kernel_bwd phases hold the presets' attention shapes too
   (PRESET_SHAPES, PRESET_BWD_SHAPES; BIG_SHAPE checked at batch 1 against
   the plain version, each of its 20 elements against the batch-1 call's
   bits, timed at batch 20), and kernel_gn their GroupNorm inputs (batch 12, 2.84 M voxels,
   16 groups).

15. follow_ups: the trainers' follow-ups at the full width of
   ``config_train_32g.json``. Remat: one bf16 stage-2 step (conditional,
   batch 20, 80^3) and one adversarial bf16 stage-1 step (batch 1, 64^3,
   LPIPS) with remat unset, ``full`` and ``convs``, from the same weights
   and draws (after one warm-up step), with cuDNN's deterministic
   algorithms: every optimizer's gradients and the step's metrics within
   2^-7 of the unremated step's (relative to each tensor's largest |g|;
   a second unremated step gives the spread); the launches by kernel and
   route exactly the unremated step's plus the forward launches of the
   GroupNorms and attention blocks inside the wrapped blocks
   (``_remat_recompute``, from the models' structure); then, with cuDNN as
   the run set it, ms a step (median of 3 after a warm-up, the modes in
   turns) and peak memory. The same for ``config_train_pp.json``'s stage-2
   step with remat unset and ``full`` (its ``mid_stack`` blocks hold
   attention, so B1/B2 rerun in the backward). Accumulation: fp32, TF32
   off, the mean gradient that ``--grad-accum 2`` hands to clip and Adam
   over the halves of a batch of 20 (the batch-20 draws split) within
   ACCUM_TOL (5e-5) of the batch-20 step's largest |g|, two planted faults
   above it, one update emitted on the second micro-step only. Profile:
   ``cli.train_autoencoder`` at one ResBlock a level for 5 bf16 steps with
   ``--profile --remat convs --grad-accum 2 --track --debug-nans``: one
   Chrome trace naming ``gn_sums_onepass``, one tracked run. Preemption:
   ``cli.train_diffusion`` in a subprocess (config_train_stable's models at
   batch 2, ``--remat full --grad-accum 2``) gets SIGTERM after its first
   step: exit 75, ``last`` with meta epoch -1 and ``preempted``, the
   accumulation state in it; a resumed run (``--track --debug-nans
   --profile``) replays epoch 0.
   ``device_prefetch`` on the card.

16. data_tools: ``cli.prepare_data`` over ragged low/high volumes (``.npy``,
   ``.npz`` and ``.nii``) fitted to 96^3; every written pair read through
   the native NPZ loader (``csrc/npz_loader.cpp``, built with g++; the
   dataset's counter must count each file on the native path) and bit-equal
   to the numpy path, ``load_batch`` too; ``scale_intensity_percentiles`` on
   the card at (2, 96, 96, 96, 1) within 1e-6 of the CPU. Calibration: the
   allocator's peak (``max_memory_reserved`` less what earlier phases left
   reserved) of adversarial bf16 stage-1 steps (32g's VAE, the CLI's
   discriminator, LPIPS) at ``check_system.CALIBRATION``'s points and under
   ``--remat convs`` and ``full`` at the largest, the device memory held
   outside the allocator, the fit (state + bytes a voxel); the advisor's
   model must be within 5 % of every point. The advisor:
   ``cli.check_system`` on the card (the >= 24 GiB tier: 32g, batch 2,
   96^3), then its recipe (warmup_epochs -1, one epoch) through
   ``cli.train_autoencoder`` on the prepared data: 3 bf16 steps and one
   validation batch, every attention launch at DATA_ATTN_SHAPE, (2, 13824,
   1, 256), the launches by route; then the recipe it gives a 16 GiB card
   (32g, batch 8, 64^3, its remat choice) for 3 steps on synthetic volumes
   with the allocator capped so that the process has 16 GiB. For both the
   measured peak (the allocator's and what lies outside it) must leave the
   20 % headroom the recommendation claims, and the model must be within 5 %
   of the allocator's part. The pipeline: ``TrainingPipeline.run_local``
   over the prepared data with the advisor's config (one epoch a stage,
   bf16): its evaluation must take the sampled path, and the run must
   launch every attention and GroupNorm kernel. Every attention input that
   these runs gave the kernels (the wrappers' ``cases``) that the kernel
   phases do not hold is held to the plain versions and timed here, forward
   and backward, and their GroupNorm inputs go to the kernel_gn phase. The
   memory gates are read once every part has printed its readings. The
   whole script runs this phase first, right after build, so that no
   earlier phase holds blocks of the caching allocator.

17. parallel: data parallelism (``ldm3d_torch.parallel``) at the full width
   of ``config_train_32g.json``, on ranks the port's launcher starts
   (``RankPool``, rank functions in ``tools/dp_check.py``). (a) Two
   ranks time-share the one card over gloo with CUDA tensors (NCCL refuses
   two ranks on one GPU): the fp32 stage-2 step (TF32 off) at 10 a rank,
   its gradients after the ranks' mean against the one-process batch-20
   gradients on the same draws, within PARALLEL_GRAD_TOL of their largest
   |g|, and the gradients three faulty programs would hold (each rank its
   own: the all-reduce skipped; rank 0's on every rank: a rank that took the
   other's rows; the ranks' sum), formed from the same run, each above
   PARALLEL_FAULT_FLOOR; the same for the adversarial stage-1 step at
   1 a rank, 64^3; one fp32 ZeRO-1 step's update (params less the start)
   against the plain data-parallel stage-2 step's from the same weights,
   over its largest |update|, within PARALLEL_ZERO_TOL, beside a second
   plain step's (the card's run-to-run spread) and a ZeRO-1 without its
   gather (formed from the same run), which must read above
   PARALLEL_ZERO_FAULT_FLOOR; ``cli.inference -g 2``, DDIM-
   10, batch 2, fp32, on the ranks against the one-process batch-2 sample of
   the same noise, within 1e-3; each rank's launches by route of one bf16
   data-parallel step equal to the one-process step's at 10 (every kernel of
   the path launched), and the mean of 3 bf16 steps timed (two ranks
   time-sharing one card: not a multi-card figure). (b) This process alone
   in a NCCL group (``group_of_one``): one bf16 step at batch 2 under
   ``fully_shard`` launches what the unwrapped step
   launches, and its full-state checkpoint loads into a one-process state
   bit for bit. (c) Depth sharding (``--spatial``) on the same two
   ranks, laid out as one data replica of two depth slabs, at the full
   width of ``config_train_multigpu.json`` (64^3, which 2 * 2^4 divides;
   depth cut to a global batch of 2 and 2 bf16 steps): the fp32 spatial
   stage-2 step's gradients (TF32 off), summed over the slabs, within
   PARALLEL_GRAD_TOL of the one-process step's on the same draws, and a
   faulty program's (the slab sum skipped) above PARALLEL_FAULT_FLOOR;
   each rank's launches by route of a bf16 spatial step equal to the
   one-process step's on the whole volumes, a second step timed (two
   ranks time-sharing one card), and the bytes and seconds of the spatial
   collectives and the gradient all-reduce of the first; then
   ``cli.inference -g 2 --spatial 2`` (fp32 DDIM-10, the condition
   through the spatial encoder, rank 0 writing the gathered volume) over
   the preset's seeded checkpoints, its volume within PARALLEL_SAMPLE_TOL
   of the one-process ``cli.inference`` run's. Every attention input these
   runs gave the kernels (local queries against the gathered keys and
   values) is held to the plain versions and timed
   (``parallel_spatial_kernel_fwd``/``_bwd``), and their GroupNorm inputs
   go to the kernel_gn phase (the bf16 step's timed).

The GroupNorm kernel phase (7) runs after the serving, presets and
data_tools paths, and replays the inputs of every main-path run (the
discriminator's instance norms, g = C, among them): it checks every input
and times those of the sampling, training and serving paths
(``GN_TIMED_PATHS``); with ``--phases presets`` or ``data_tools`` it replays
and times that phase's.

Precision: the kernel phases (3, 4, 9, 10) run with both ``allow_tf32``
flags False, so that the plain versions, SDPA and cuDNN compute in full
fp32, and restore the flags after them. Before each main path's entry point
(the inference and both training CLIs' ``main``, ``ModelServer.load_model``) the
script sets both flags True, and each main-path line records them as the
entry point left them: every entry point must pin both to False (full fp32).

Times are device ms per call (CUDA events around back-to-back calls, median
of 5 loops); ``*_host_ms`` is the host's cost to issue one call;
``bound_ms`` is the larger of the bytes over 3.35 TB/s and the flops over
the peak for the inputs' type (989 TFLOP/s bf16 tensor cores; fp32 at
495 / 3 = 165 TFLOP/s, the rate of fp32-accurate products on the TF32
tensor cores, three TF32 products each). The last three lines are the
kernels' summary JSON (seven rows: the forward, its wgmma route alone, dQ,
dK/dV, the two GroupNorm sums, the conv; each also with the distillation
runs' launches, in all and a step), the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances of the kernels against their plain versions. Both compute in
# fp32 from the same inputs, so they differ by summation order only: 1e-4 on
# the fp32 O and on the LSE in both dtypes. A bf16 O is that fp32 result
# rounded once, so an element may differ by one bf16 ulp of itself, at most
# 2^-7 of the largest |O| of the shape: the bf16 limit is 2^-7 * max|O_plain|.
TOL_FP32 = 1e-4
BF16_OUT_REL = 2.0**-7
# Attention gradients: fp32 within 1e-4 of the largest |grad| of each output
# (relative: dQ/dK reach ~10 at n = 8000), bf16 within one bf16 ulp of it.
GRAD_FP32_REL = 1e-4
# GroupNorm sums: fp32 sums of up to 10^7 terms in different orders (chunked
# partials against torch's reduction): within 1e-5 of the sum of the
# absolute terms of each (batch, channel).
GN_REL = 1e-5


def out_tol(dtype: str, ref_max: float) -> float:
    return TOL_FP32 if dtype == "float32" else BF16_OUT_REL * ref_max


def grad_tol(dtype: str, ref_max: float) -> float:
    return (GRAD_FP32_REL if dtype == "float32" else BF16_OUT_REL) * ref_max


# dense peaks of the H100 SXM: bf16 tensor cores; fp32 as 3xTF32 on the TF32
# tensor cores (495 TFLOP/s over three products), above the CUDA cores' 67
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# (B, n, h, d): UNet level 1 and 2 and VAE level 2 at 80^3 (the CLI's patch)
# and at 96^3 (BASELINE.json's size); a batch-2 case; a ragged odd case; the
# VAE's level 2 at the stage-1 training patch (64^3)
MAIN_SHAPES = [(1, 1000, 8, 64), (1, 125, 16, 64), (1, 8000, 1, 256)]
SHAPES = MAIN_SHAPES + [(1, 1728, 8, 64), (1, 216, 16, 64), (1, 13824, 1, 256),
                        (2, 1000, 8, 64), (2, 125, 16, 64), (2, 8000, 1, 256), (2, 100, 3, 40),
                        (1, 4096, 1, 256)]
# launches of each MAIN_SHAPES entry in one flagship sample (batch 1, DDIM-50):
# 5 UNet level-1 and 6 level-2 attentions per step, 2 in the encoder, 2 in the decoder
LAUNCHES_PER_SAMPLE = {MAIN_SHAPES[0]: 250, MAIN_SHAPES[1]: 300, MAIN_SHAPES[2]: 4}
# (B, n, h, d[, kv_len]): the edge cases of the ``cuda`` tests, bf16 only:
# head widths of each instantiation (d <= 64, 128, 256; d not a multiple of
# 16), token counts off the 128-row query and 64-key kv tiles, kv_len != n
EDGE_SHAPES = [(2, 63, 3, 8), (1, 1, 2, 64), (3, 129, 2, 72), (2, 65, 2, 136),
               (1, 63, 1, 256, 65), (1, 1, 1, 256, 8000), (2, 100, 4, 64, 37)]
# (B, n, h, d): head widths the kernels once refused (36: not a multiple of
# 8, padded; 320 and 512: above 256, the wide route) and batch * heads past
# 65,535, at small n, in both dtypes
C2_SHAPES = [(2, 70, 3, 36), (1, 150, 2, 320), (2, 70, 1, 512), (1, 1000, 1, 512),
             (35000, 8, 2, 16)]
# the attention forward's route for each dtype (csrc/flash_fwd.cu) up to
# d = 256, and for d > 256 in both
FWD_ROUTES = {"bf16": "mma.sync bf16 tensor cores (d <= 128)",
              "bf16_wgmma": "wgmma bf16 tensor cores on TMA-loaded tiles, thread 0 the producer "
                            "(128 < d <= 256)",
              "fp32": "mma.sync tf32 tensor cores, 3xTF32 split",
              "wide": "scalar FMA, head dims of O over grid.y (d > 256)"}
# the attention backward's (csrc/flash_bwd.cu), both kernels
BWD_ROUTES = {"bf16": "mma.sync bf16 tensor cores, P/dS hi-lo split (128 < d <= 256)",
              "bf16_wgmma": "wgmma bf16 tensor cores on TMA-loaded tiles, thread 0 the producer, "
                            "P/dS hi-lo split (d <= 128)",
              "fp32": "mma.sync tf32 tensor cores, 3xTF32 split",
              "wide": "scalar FMA, head dims of dQ and dK/dV over grid.y (d > 256)"}


def fwd_route(dtype: str, d: int) -> str:
    """The port's forward route id (``ldm3d_torch.ops.attention.fwd_route_id``)
    at head width d, which the wrapper pads to a multiple of 8."""
    import torch
    from ldm3d_torch.ops.attention import fwd_route_id

    return fwd_route_id(getattr(torch, dtype), -(-d // 8) * 8)


def bwd_route(dtype: str, d: int) -> str:
    """The port's backward route id (``ldm3d_torch.ops.attention.bwd_route_id``)
    at head width d, which the wrapper pads to a multiple of 8."""
    import torch
    from ldm3d_torch.ops.attention import bwd_route_id

    return bwd_route_id(getattr(torch, dtype), -(-d // 8) * 8)
DDIM_STEPS = 50
# the profiled sample of the main path: DDIM-10 (a profiled DDIM-50 sample
# took about 65 s of the script's time limit)
PROFILE_DDIM_STEPS = 10

# Training main path: the config's batch 20 at its 80^3 patch; 90 synthetic
# pairs give 81 training pairs (4 steps of 20, the first a warm-up) and 9
# validation pairs (one padded batch).
TRAIN_BATCH = 20
TRAIN_PAIRS = 90
TRAIN_SHAPES = [(20, 1000, 8, 64), (20, 125, 16, 64), (20, 8000, 1, 256)]
# attention launches per training step at each TRAIN_SHAPES entry: the UNet's
# 5 level-1 and 6 level-2 attentions (forward and backward); the forward
# also runs 2 VAE encodes x 2 encoder attentions
TRAIN_FWD_PER_STEP = {TRAIN_SHAPES[0]: 5, TRAIN_SHAPES[1]: 6, TRAIN_SHAPES[2]: 4}
# the UNet's attention in a guided distillation step's teacher forwards:
# conditional and unconditional halves as one batch of 40
DISTILL_CFG_SHAPES = [(40, 1000, 8, 64), (40, 125, 16, 64)]
TRAIN_BWD_PER_STEP = {TRAIN_SHAPES[0]: 5, TRAIN_SHAPES[1]: 6}
# Stage-1 main path: config_train_32g.json's autoencoder_train (batch 1, a
# 64^3 random crop) on synthetic 80^3 pairs, through a copy of the preset
# with warmup_epochs 0, val_interval 1 and 2 epochs: epoch 0 runs the
# warm-up generator step, epoch 1 the adversarial generator and
# discriminator steps, each epoch ends with one validation batch (80^3,
# the 1.5x-rounded crop clamped to the volume). 6 pairs: 6 steps an epoch.
AE_PAIRS = 6
AE_PATCH = (64, 64, 64)
AE_VOLUME = (80, 80, 80)
# the VAE's d = 256 attention at the 64^3 training patch (level 2: 16^3
# tokens); the validation batch runs MAIN_SHAPES[2], (1, 8000, 1, 256)
AE_TRAIN_SHAPE = (1, 4096, 1, 256)
BWD_SHAPES = TRAIN_SHAPES[:2] + [(2, 100, 3, 40), (1, 8000, 1, 256), AE_TRAIN_SHAPE]
# (B, n, h, d[, kv_len]): the backward edge cases of the ``cuda`` tests, in
# both dtypes: every instantiation (DMAX 64, 128, 256, and dK/dV's head-dim
# split at d > 128), token counts off the row and key tiles of either route, n = 1
# (beside more than one key: with one, dQ and dK are 0), kv_len != n, the
# training shapes at batch 2
BWD_EDGE_SHAPES = [(2, 63, 3, 8), (1, 1, 2, 64, 37), (3, 129, 2, 72), (2, 65, 2, 136),
                   (1, 63, 1, 256, 65), (1, 1, 1, 256, 8000), (2, 100, 4, 64, 37),
                   (2, 1000, 8, 64), (2, 125, 16, 64)]
# (B, n, h, d): the attention shapes of the presets phase's models (PRESETS)
# that no other path runs: 16g's UNet over its odd latent 36 x 44 x 28 (5,544
# and 693 tokens; training batch 2, sampling batch 1); multigpu's VAE at
# levels 1 (d = 128, 32^3 tokens) and 2 (its stage-2 encodes at batch 20)
# and its UNet at 64^3 crops; stable's VAE (d = 128) and UNet (d = 32 over 27
# tokens, 16 heads); pp's extra mid blocks run (20, 125, 16, 64)
PRESET_SHAPES = [(2, 5544, 4, 64), (2, 693, 8, 64), (1, 5544, 4, 64), (1, 693, 8, 64),
                 (1, 32768, 1, 128), (20, 4096, 1, 256), (20, 512, 8, 64), (20, 64, 16, 64),
                 (1, 512, 8, 64), (1, 64, 16, 64), (1, 1728, 1, 128), (10, 1728, 1, 128),
                 (10, 27, 16, 32), (1, 27, 16, 32)]
# multigpu's stage-2 encodes at batch 20 at level 1: the plain version's fp32
# scores (20 x 32768^2) do not fit on the card, so the kernel is held to it at
# batch 1 (PRESET_SHAPES) and timed at batch 20, where each batch element
# must give the bits of the batch-1 call on that element
BIG_SHAPE = (20, 32768, 1, 128)
# the backward at the presets' training shapes (stage 1: multigpu's and
# stable's VAE at d = 128; stage 2: 16g, multigpu and stable's UNets)
PRESET_BWD_SHAPES = [(1, 32768, 1, 128), (1, 1728, 1, 128), (2, 5544, 4, 64), (2, 693, 8, 64),
                     (20, 512, 8, 64), (20, 64, 16, 64), (10, 27, 16, 32)]
# every shape the kernel and kernel_bwd phases hold, in both dtypes
FWD_KERNEL_SHAPES = (SHAPES + TRAIN_SHAPES + DISTILL_CFG_SHAPES + PRESET_SHAPES + EDGE_SHAPES
                     + C2_SHAPES)
BWD_KERNEL_SHAPES = BWD_SHAPES + PRESET_BWD_SHAPES + BWD_EDGE_SHAPES
# B6's route for each dtype (csrc/conv3d_igemm.cu)
CONV_ROUTES = {"bfloat16": "wgmma bf16 tensor cores, implicit GEMM over a staged input slab",
               "float32": "mma.sync tf32 tensor cores, 3xTF32 split, per-tap partials"}
# kernel instantiations that must not spill, by library: (name prefix, count)
NO_SPILL = {
    "libflash_fwd-": (("flash_fwd_bf16_mma_kernel<", 2), ("flash_fwd_bf16_wgmma_kernel", 1),
                      ("flash_fwd_tf32x3_mma_kernel<", 3), ("flash_fwd_wide_kernel<", 2)),
    "libflash_bwd-": (("flash_bwd_dq_bf16_wgmma_kernel<", 2), ("flash_bwd_dkv_bf16_wgmma_kernel<", 2),
                      ("flash_bwd_dq_bf16_mma_kernel<", 1), ("flash_bwd_dkv_bf16_mma_kernel<", 1),
                      ("flash_bwd_dq_tf32x3_mma_kernel<", 3),
                      ("flash_bwd_dkv_tf32x3_mma_kernel<", 3),
                      ("flash_bwd_dq_wide_kernel<", 2), ("flash_bwd_dkv_wide_kernel<", 2)),
    # B4 and B5 each: 2 dtypes x 2 load widths x 2 combines
    "libgroupnorm_sums-": (("gn_sums_onepass<", 8), ("gn_bwd_sums_onepass<", 8)),
    "libconv3d_igemm-": (("conv3d_igemm_wgmma_kernel", 1), ("conv3d_igemm_tf32x3_kernel", 1)),
}
# wgmma kernels whose products ptxas must not serialize (its C75xx "wgmma
# ... serialized" warnings), by library; a warning that names no kernel fails too
NO_SERIALIZED = {"libflash_bwd-": ("flash_bwd_dq_bf16_wgmma_kernel<",
                                   "flash_bwd_dkv_bf16_wgmma_kernel<")}
# launches of each fp32 attention shape in one merged batch-2 DDIM-50 serving
# call: the two requests' conditions encoded at batch 1 (2 encoder attentions
# each), 50 UNet steps at batch 2 (5 level-1, 6 level-2), one batch-2 decode
SERVE_FWD_PER_CALL = {(1, 8000, 1, 256): 4, (2, 1000, 8, 64): 250, (2, 125, 16, 64): 300,
                      (2, 8000, 1, 256): 2}
# the scalar fp32 backward kernels that the 3xTF32 route replaced (PERF.md's
# kernel table, H100 80GB HBM3 at 700 W): ms a call, beside the new ones'
SCALAR_FP32_BWD = {TRAIN_SHAPES[0]: {"scalar_dq_ms": 3.503, "scalar_dkv_ms": 4.196}}
# Recorded figures, not measured by this script: the kernels that the wgmma
# forward and the tensor-core conv replaced, as commit 4e54ad0 has them,
# timed by that commit's own chip_smoke.py kernel phase and tools/conv_ab.py
# before and after this script in one call, on the same card (PERF.md, H100
# 80GB HBM3 at 700 W): ms a call, the mean of the two. The phase lines carry
# them as ``recorded_earlier_ms``. The bf16 forward at 128 < d <= 256 ran
# flash_fwd_bf16_mma_kernel (mma.sync); B6 the scalar FMA conv.
EARLIER_FWD_MS = {((20, 8000, 1, 256), "bfloat16"): 7.275, ((2, 8000, 1, 256), "bfloat16"): 0.7489,
              ((1, 8000, 1, 256), "bfloat16"): 0.763, ((1, 13824, 1, 256), "bfloat16"): 1.281,
              ((2, 65, 2, 136), "bfloat16"): 0.01564, ((1, 63, 1, 256, 65), "bfloat16"): 0.01655,
              ((1, 1, 1, 256, 8000), "bfloat16"): 0.7536}
# The mma.sync pair (flash_bwd_dq_bf16_mma_kernel, flash_bwd_dkv_bf16_mma_kernel)
# that the wgmma backward replaced at d <= 128, as commit a195c6b has it,
# timed by that commit's own kernel_bwd phase before and after this script
# in one call, on the same card (PERF.md, H100 80GB HBM3 at 700 W): ms a
# call, the mean of the two.
EARLIER_BWD_MS = {
    ((20, 1000, 8, 64), "bfloat16"): {"dq": 0.37, "dkv": 0.5074},
    ((20, 125, 16, 64), "bfloat16"): {"dq": 0.02316, "dkv": 0.02949},
    ((2, 100, 3, 40), "bfloat16"): {"dq": 0.01014, "dkv": 0.01228},
    ((2, 63, 3, 8), "bfloat16"): {"dq": 0.006218, "dkv": 0.007214},
    ((1, 1, 2, 64, 37), "bfloat16"): {"dq": 0.006819, "dkv": 0.006203},
    ((3, 129, 2, 72), "bfloat16"): {"dq": 0.0171, "dkv": 0.0195},
    ((2, 100, 4, 64, 37), "bfloat16"): {"dq": 0.007071, "dkv": 0.01286},
    ((2, 1000, 8, 64), "bfloat16"): {"dq": 0.05682, "dkv": 0.07517},
    ((2, 125, 16, 64), "bfloat16"): {"dq": 0.01077, "dkv": 0.01352},
}
EARLIER_CONV_MS = {((8, 64, 64, 64, 64), "bfloat16"): 29.47, ((8, 64, 64, 64, 64), "float32"): 29.36,
               ((8, 96, 96, 96, 64), "bfloat16"): 99.03, ((8, 96, 96, 96, 64), "float32"): 99.37,
               ((2, 96, 96, 96, 64), "bfloat16"): 25.0, ((2, 96, 96, 96, 64), "float32"): 24.92,
               ((1, 80, 80, 80, 64), "bfloat16"): 7.268, ((1, 80, 80, 80, 64), "float32"): 7.248}
# PR 5's B4 figures (PERF.md, H100 80GB HBM3 at 700 W): device and host ms
# summed over each path's launches, and the host ms of one call
PR5_GN_SUMS = {"sampling": {"ms": 15.96, "host_ms": 209.0}, "serving": {"ms": 79.84,
               "host_ms": 777.9}, "training": {"ms": 36.73, "host_ms": 33.20},
               "host_ms_per_call": 0.090}
# Recorded figures, not measured by this script: B5's split pass + combine
# pair that gn_bwd_sums_onepass replaced, as commit ee8c90c has it, timed by
# that commit's own chip_smoke.py (PERF.md, H100 80GB HBM3 at 700 W): device
# and host ms summed over each path's launches (396 a stage-1 run), and
# device ms (and host ms at gn_bwd_host's input) a call by input, x and dy
# channels_last_3d
EARLIER_GN_BWD_SUMS = {
    "host_ms": {((1, 256, 16, 16, 16), "bfloat16"): 0.0439},
    "paths": {"training_ae": {"ms": 8.681, "host_ms": 27.17},
              "training_ae_fp32": {"ms": 11.22, "host_ms": 30.25},
              "training": {"ms": 6.856, "host_ms": 12.26},
              "training_fp32": {"ms": 10.14, "host_ms": 10.47}},
    "ms": {((1, 64, 16, 16, 16), "bfloat16"): 0.006722, ((1, 64, 16, 16, 16), "float32"): 0.006514,
           ((1, 64, 32, 32, 32), "bfloat16"): 0.01163, ((1, 64, 32, 32, 32), "float32"): 0.01215,
           ((1, 64, 64, 64, 64), "bfloat16"): 0.05392, ((1, 64, 64, 64, 64), "float32"): 0.07143,
           ((1, 128, 8, 8, 8), "bfloat16"): 0.006133, ((1, 128, 8, 8, 8), "float32"): 0.005957,
           ((1, 128, 16, 16, 16), "bfloat16"): 0.006782,
           ((1, 128, 16, 16, 16), "float32"): 0.00663,
           ((1, 128, 32, 32, 32), "bfloat16"): 0.01312, ((1, 128, 32, 32, 32), "float32"): 0.01471,
           ((1, 128, 64, 64, 64), "bfloat16"): 0.07608, ((1, 128, 64, 64, 64), "float32"): 0.1044,
           ((1, 256, 16, 16, 16), "bfloat16"): 0.006829,
           ((1, 256, 16, 16, 16), "float32"): 0.006752,
           ((1, 256, 32, 32, 32), "bfloat16"): 0.01846, ((1, 256, 32, 32, 32), "float32"): 0.03393,
           ((20, 256, 10, 10, 10), "bfloat16"): 0.009488,
           ((20, 256, 10, 10, 10), "float32"): 0.01329,
           ((20, 256, 20, 20, 20), "bfloat16"): 0.08519, ((20, 256, 20, 20, 20), "float32"): 0.1235,
           ((20, 512, 5, 5, 5), "bfloat16"): 0.006218, ((20, 512, 5, 5, 5), "float32"): 0.006408,
           ((20, 512, 10, 10, 10), "bfloat16"): 0.01856, ((20, 512, 10, 10, 10), "float32"): 0.03392,
           ((20, 512, 20, 20, 20), "bfloat16"): 0.1578, ((20, 512, 20, 20, 20), "float32"): 0.2289,
           ((20, 768, 10, 10, 10), "bfloat16"): 0.03098, ((20, 768, 10, 10, 10), "float32"): 0.04775,
           ((20, 768, 20, 20, 20), "bfloat16"): 0.2281, ((20, 768, 20, 20, 20), "float32"): 0.3337,
           ((20, 1024, 5, 5, 5), "bfloat16"): 0.007267, ((20, 1024, 5, 5, 5), "float32"): 0.007829,
           ((20, 1024, 10, 10, 10), "bfloat16"): 0.04044,
           ((20, 1024, 10, 10, 10), "float32"): 0.06166,
           ((20, 1536, 5, 5, 5), "bfloat16"): 0.008701, ((20, 1536, 5, 5, 5), "float32"): 0.009958,
           ((20, 1536, 10, 10, 10), "bfloat16"): 0.05596,
           ((20, 1536, 10, 10, 10), "float32"): 0.08712,
           ((20, 2048, 5, 5, 5), "bfloat16"): 0.01001, ((20, 2048, 5, 5, 5), "float32"): 0.01827}}
# card-vs-CPU train step: loss relative 1e-5; each gradient leaf within 1e-3
# of its largest |g| (fp32 convolutions summed in other orders through the
# whole UNet forward and back); parameters within 2 lr + 1e-6: Adam's first
# update is +-lr sign(g), so an element whose gradient is at rounding level
# may move the other way
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3
TINY_LR = 1e-4
# card-vs-CPU stage-1 step: every metric (losses, the gradient norm, the
# discriminator's loss) within 1e-3 relative, as the tiny sample card vs CPU
STAGE1_REL = 1e-3

# Serving main path: the flagship models in fp32 (as the JAX server serves),
# 80^3, DDIM-50, batch 2; a dpm-20 override. The served volumes are min-max
# normalised to [0, 1]: the same request batched with another or alone, and
# the same seed served twice, may differ by fp32 summation order through 50
# steps of fp32 convolutions (cuDNN may pick its algorithms per call), held to
# 1e-3 like the tiny sample card vs CPU.
SERVE_STEPS = 50
SERVE_DPM_STEPS = 20
# the profiled request: DDIM-10, the fewest steps the REST layer takes (a
# profiled DDIM-50 request took about 57 s of the script's time limit)
SERVE_PROFILE_STEPS = 10
SERVE_BATCH = 2
SERVE_TOL = 1e-3

T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; phase lines carry the seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def full_fp32(phase):
    """Run ``phase`` with both ``allow_tf32`` flags False (the plain
    versions, SDPA and cuDNN in full fp32), and restore them after it."""
    @functools.wraps(phase)
    def run(*args, **kwargs):
        from ldm3d_torch.cli.common import tf32_flags

        with tf32_flags(False):
            return phase(*args, **kwargs)
    return run


def unpin_precision(torch) -> None:
    """Both ``allow_tf32`` flags True: the entry point that runs next has to
    pin them."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True


def pinned_precision(torch, entry: str) -> dict:
    """The two flags as ``entry`` left them; fails unless both are False."""
    flags = {"matmul": torch.backends.cuda.matmul.allow_tf32,
             "cudnn": torch.backends.cudnn.allow_tf32}
    check(not any(flags.values()), f"{entry} left allow_tf32 {flags}: fp32 is not full fp32")
    return flags


# GPU clock cycles the card spins before each timed loop (about 10 ms), so
# that the host has issued all of the loop's calls before the first one runs
SPIN_CYCLES = 20_000_000


def cuda_ms(torch, fn, calls: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device ms per call: ``calls`` back-to-back calls between one pair of
    CUDA events, divided by ``calls``; the median of ``reps`` such loops.
    Each loop is queued behind a spin kernel, so at shapes where issuing a
    call (tens of us) takes longer than running it, the loop still times the
    card and not the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Host ms to issue one call (wrapper, allocation, launch), without
    waiting for the card: the median over ``reps`` loops of ``calls``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def loop_size(flops: float) -> dict:
    """Fewer timed calls for the heaviest shapes (tens of ms a call)."""
    return {"calls": 3, "reps": 3, "warmup": 1} if flops > 2e11 else {}


def bound_of(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bound(shape, dtype: str, itemsize: int) -> tuple[float, str]:
    """Flash forward: 4 n kv d flops per head; q, k, v, O once and the LSE."""
    b, n, h, d, kv = (*shape, shape[1])[:5]
    return bound_of(4.0 * b * h * n * kv * d,
                    (2.0 * n + 2.0 * kv) * b * h * d * itemsize + 4.0 * b * h * n, dtype)


def bound_bwd(shape, dtype: str, itemsize: int, kind: str) -> tuple[float, str]:
    """dQ: 6 n kv d flops per head, reads q, dO (n rows), k, v (kv rows), LSE,
    D, writes dQ (n rows); dK/dV: 8 n kv d flops, the same reads, writes dK
    and dV (kv rows). The bf16 kernels' hi-lo split (20 units of n kv d
    where the algorithm needs 14) is not counted."""
    b, n, h, d, kv = (*shape, shape[1])[:5]
    rows = 3.0 * n + 2.0 * kv if kind == "dq" else 2.0 * n + 4.0 * kv
    return bound_of((6.0 if kind == "dq" else 8.0) * b * h * n * kv * d,
                    rows * b * h * d * itemsize + 8.0 * b * h * n, dtype)


def phase_device(torch) -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda,
          "disk_free_gib": shutil.disk_usage(ROOT).free / 2**30})
    return name, smi_line


def phase_build() -> None:
    from ldm3d_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build_libraries(_kernels.SOURCES)
    _kernels.flash_fwd_library()
    _kernels.flash_bwd_library()
    _kernels.groupnorm_library()
    _kernels.conv3d_library()
    ptxas, serialized = {}, {}
    for path in paths:
        log = path.with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        ptxas[path.name] = _kernels.ptxas_report(text)
        serialized[path.name] = _kernels.wgmma_serialized(text)
    for lib, prefixes in NO_SERIALIZED.items():
        names = next(v for name, v in serialized.items() if name.startswith(lib))
        bad = sorted(x for x in names if x is None or x.startswith(prefixes))
        check(not bad, f"ptxas serializes the wgmma of {bad} (None: a warning naming no kernel)")
    for lib, kernels in NO_SPILL.items():
        report = next(r for name, r in ptxas.items() if name.startswith(lib))
        for prefix, count in kernels:
            found = {name: r for name, r in report.items() if name.startswith(prefix)}
            check(len(found) == count, f"expected {count} {prefix}...> instantiations, ptxas "
                                       f"reports {sorted(report)}")
            spilled = {name: r for name, r in found.items()
                       if r.get("spill_stores", 1) or r.get("spill_loads", 1)}
            check(not spilled, f"kernel instantiations spill: {spilled}")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": [str(p.relative_to(ROOT)) for p in paths], "ptxas": ptxas,
          "wgmma_serialized": {k: sorted(map(str, v)) for k, v in serialized.items()}})


def _fused_qkv(torch, shape, dt, gen):
    """q, k, v as views of one fused (b, n, 3hd) qkv, or for a (b, n, h, d,
    kv_len) shape a (b, n, hd) q and views of a fused (b, kv_len, 2hd) kv;
    returns the fused tensor and the views."""
    b, n, h, d = shape[:4]
    if len(shape) == 4:
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dt)
        return qkv, tuple(t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
    q = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dt)
    kv = torch.randn((b, shape[4], 2 * h * d), generator=gen, device="cuda").to(dt)
    return kv, (q.unflatten(-1, (h, d)), *(t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1)))


def _check_fwd_plan(torch, dtype: str, shape, q, k, v) -> None:
    """The CUDA library's launch plan of the forward (ldm3d_flash_fwd_plan,
    the plan its launch reads) is the one ``ldm3d_torch.ops.attention.
    flash_fwd_plan`` gives, tensor maps included (the CPU tests hold that one
    to its grid, shared memory and legal maps)."""
    from ldm3d_torch.ops._kernels import flash_fwd_library
    from ldm3d_torch.ops.attention import FWD_ROUTE_IDS, flash_fwd_plan

    b, n, h, d = shape[:4]
    d8 = -(-d // 8) * 8  # the wrapper pads head dims to a multiple of 8
    strides = [t.stride()[:3] for t in (q, k, v)]
    out = (ctypes.c_int64 * 38)()
    check(flash_fwd_library().ldm3d_flash_fwd_plan(
              int(dtype == "bfloat16"), b, h, n, k.shape[1], d8,
              (ctypes.c_int64 * 9)(*(x for st in strides for x in st)), out) == 0,
          f"ldm3d_flash_fwd_plan refused {shape}")
    py = flash_fwd_plan(getattr(torch, dtype), b, n, h, d8, k.shape[1], strides)
    got = [FWD_ROUTE_IDS[out[0]], (out[1], out[2]), out[3], out[4]]
    want = [py["route"], py["grid"], py["threads"], py["smem_bytes"]]
    if "tensor_maps" in py:
        got += [tuple(out[5 + 11 * i:16 + 11 * i]) for i in range(3)]
        want += [(*m["dims"], *m["strides_bytes"], *m["box"])
                 for m in (py["tensor_maps"][name] for name in "qkv")]
    check(got == want, f"forward plan at {shape} {dtype}: CUDA {got}, Python {want}")


def _check_bwd_plan(torch, dtype: str, shape, q, k, v, do) -> None:
    """The CUDA library's launch plans of dQ and dK/dV
    (ldm3d_flash_bwd_plan, the plans their launches read) are the ones
    ``ldm3d_torch.ops.attention.flash_bwd_plan`` gives, tensor maps
    included (the CPU tests hold those to coverage, shared memory and legal
    maps)."""
    from ldm3d_torch.ops._kernels import flash_bwd_library
    from ldm3d_torch.ops.attention import BWD_ROUTE_IDS, flash_bwd_plan

    b, n, h, d = shape[:4]
    d8 = -(-d // 8) * 8
    strides = [t.stride()[:3] for t in (q, k, v, do)]
    for kind in ("dq", "dkv"):
        out = (ctypes.c_int64 * 49)()
        check(flash_bwd_library().ldm3d_flash_bwd_plan(
                  int(kind == "dkv"), int(dtype == "bfloat16"), b, h, n, k.shape[1], d8,
                  (ctypes.c_int64 * 12)(*(x for st in strides for x in st)), out) == 0,
              f"ldm3d_flash_bwd_plan refused {shape} {kind}")
        py = flash_bwd_plan(kind, getattr(torch, dtype), b, n, h, d8, k.shape[1], strides)
        got = [BWD_ROUTE_IDS[out[0]], (out[1], out[2]), out[3], out[4]]
        want = [py["route"], py["grid"], py["threads"], py["smem_bytes"]]
        if "tensor_maps" in py:
            got += [tuple(out[5 + 11 * i:16 + 11 * i]) for i in range(4)]
            want += [(*m["dims"], *m["strides_bytes"], *m["box"])
                     for m in (py["tensor_maps"][name] for name in ("q", "k", "v", "dO"))]
        check(got == want, f"{kind} plan at {shape} {dtype}: CUDA {got}, Python {want}")


@full_fp32
def phase_kernel(torch, F) -> dict:
    """Forward kernel against plain version at every shape and dtype; returns
    the per-(shape, dtype) measurements."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    shapes = FWD_KERNEL_SHAPES
    cases = [("bfloat16", s) for s in shapes] + [("float32", s) for s in shapes]
    for dtype, shape in cases:
        results[(shape, dtype)] = _fwd_case(torch, F, dtype, shape, gen)
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        results[(BIG_SHAPE, dtype)] = _kernel_big(torch, F, dtype, gen, results)
    return results


def _fwd_case(torch, F, dtype: str, shape, gen, phase: str = "kernel") -> dict:
    """The forward kernel at one shape and dtype: its route's count rises by
    one, O and the LSE within their limits of the plain version; device ms
    of the kernel, the plain version and SDPA, host ms, the bound."""
    from ldm3d_torch.ops.attention import attention_reference, flash_attention_fwd

    dt = getattr(torch, dtype)
    b, n, h, d = shape[:4]
    qkv, (q, k, v) = _fused_qkv(torch, shape, dt, gen)
    _check_fwd_plan(torch, dtype, shape, q, k, v)
    route = fwd_route(dtype, d)
    before = flash_attention_fwd.route_launches[route]
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    check(flash_attention_fwd.route_launches[route] == before + 1,
          f"the {route} route did not run at {shape} {dtype}")
    ref, ref_lse = attention_reference(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    tol = out_tol(dtype, ref.float().abs().max().item())
    del ref, ref_lse
    check(math.isfinite(err) and err <= tol,
          f"kernel O differs from plain by {err} (limit {tol}) at {shape} {dtype}")
    check(math.isfinite(lse_err) and lse_err <= TOL_FP32,
          f"kernel LSE differs from plain by {lse_err} at {shape} {dtype}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    loop = loop_size(4.0 * b * h * n * k.shape[1] * d)
    row = {
        "kernel_ms": cuda_ms(torch, lambda: flash_attention_fwd(q, k, v), **loop),
        "kernel_host_ms": host_ms(torch, lambda: flash_attention_fwd(q, k, v)),
        "plain_ms": cuda_ms(torch, lambda: attention_reference(q, k, v), **loop),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                              **loop),
        "max_abs_err": err, "lse_max_abs_err": lse_err,
    }
    row["bound_ms"], row["bound_by"] = bound(shape, dtype, qkv.element_size())
    if (shape, dtype) in EARLIER_FWD_MS:
        row["recorded_earlier_ms"] = EARLIER_FWD_MS[(shape, dtype)]
    emit({"phase": phase, "kernel": "flash_fwd", "shape_bnhd": list(shape[:4]),
          "kv_len": k.shape[1], "dtype": dtype, "route": FWD_ROUTES[route], **row,
          "tflops": 4.0 * b * h * n * k.shape[1] * d / row["kernel_ms"] / 1e9,
          "out_tol": tol, "lse_tol": TOL_FP32})
    del qkv, q, k, v, out, lse
    return row


def _kernel_big(torch, F, dtype: str, gen, results: dict) -> dict:
    """BIG_SHAPE: the kernel and SDPA timed at batch 20; held to the plain
    version through the batch-1 row (same n, h, d), and every batch element
    to the bits of the batch-1 call on that element alone."""
    from ldm3d_torch.ops.attention import flash_attention_fwd

    dt = getattr(torch, dtype)
    b, n, h, d = BIG_SHAPE
    qkv, (q, k, v) = _fused_qkv(torch, BIG_SHAPE, dt, gen)
    _check_fwd_plan(torch, dtype, BIG_SHAPE, q, k, v)
    route = fwd_route(dtype, d)
    before = flash_attention_fwd.route_launches[route]
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    check(flash_attention_fwd.route_launches[route] == before + 1,
          f"the {route} route did not run at {BIG_SHAPE} {dtype}")
    check(bool(torch.isfinite(out).all()), f"non-finite output at {BIG_SHAPE} {dtype}")
    for i in range(b):
        one, one_lse = flash_attention_fwd(q[i:i + 1], k[i:i + 1], v[i:i + 1])
        check(torch.equal(out[i:i + 1], one) and torch.equal(lse[i:i + 1], one_lse),
              f"batch element {i} at {BIG_SHAPE} {dtype} differs from the batch-1 call")
    check(flash_attention_fwd.route_launches[route] == before + 1 + b,
          f"the {route} route did not run the batch-1 calls at {BIG_SHAPE} {dtype}")
    b1 = results[((1, n, h, d), dtype)]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    loop = loop_size(4.0 * b * h * n * n * d)
    row = {"kernel_ms": cuda_ms(torch, lambda: flash_attention_fwd(q, k, v), **loop),
           "kernel_host_ms": host_ms(torch, lambda: flash_attention_fwd(q, k, v), calls=3,
                                     reps=3),
           "plain_ms": None, "plain_ms_at_batch_1": b1["plain_ms"],
           "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                 **loop),
           "max_abs_err": b1["max_abs_err"], "lse_max_abs_err": b1["lse_max_abs_err"],
           "checked_at": "batch 1 against the plain version; each of batch 20's elements "
                         "bit-equal to the batch-1 call on it"}
    row["bound_ms"], row["bound_by"] = bound(BIG_SHAPE, dtype, qkv.element_size())
    emit({"phase": "kernel", "kernel": "flash_fwd", "shape_bnhd": list(BIG_SHAPE),
          "kv_len": n, "dtype": dtype, "route": FWD_ROUTES[route], **row,
          "tflops": 4.0 * b * h * n * n * d / row["kernel_ms"] / 1e9})
    del qkv, q, k, v, out, lse, one, one_lse, qt, kt, vt
    torch.cuda.empty_cache()
    return row


@full_fp32
def phase_kernel_bwd(torch, F) -> dict:
    """dQ and dK/dV kernels against their plain versions; returns the
    per-(shape, dtype) measurements."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    shapes = BWD_KERNEL_SHAPES
    cases = [("bfloat16", s) for s in shapes] + [("float32", s) for s in shapes]
    for dtype, shape in cases:
        results[(shape, dtype)] = _bwd_case(torch, F, dtype, shape, gen)
    return results


def _bwd_case(torch, F, dtype: str, shape, gen, phase: str = "kernel_bwd") -> dict:
    """dQ and dK/dV at one shape and dtype (TF32 off): their route's counts
    rise, the same bits on a second run, each gradient within its limit of
    the plain version; device ms of each kernel, the plain versions and
    SDPA's backward, host ms, the bounds."""
    from ldm3d_torch.ops import attention as A

    dt = getattr(torch, dtype)
    b, n, h, d = shape[:4]
    qkv, (q, k, v) = _fused_qkv(torch, shape, dt, gen)
    do = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dt)
    _check_bwd_plan(torch, dtype, shape, q, k, v, do)
    out, lse = A.flash_attention_fwd(q, k, v)
    dvec = A.attention_bwd_dvec(do, out)
    route = bwd_route(dtype, d)
    before = [fn.route_launches[route] for fn in (A.flash_attention_bwd_dq,
                                                   A.flash_attention_bwd_dkv)]
    grads = A.flash_attention_bwd(q, k, v, out, lse, do)
    again = A.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    check([fn.route_launches[route] for fn in (A.flash_attention_bwd_dq,
                                               A.flash_attention_bwd_dkv)]
          == [x + 2 for x in before], f"the {route} backward route did not run at {shape} "
                                      f"{dtype}")
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"flash_bwd gave other gradients on a second run at {shape} {dtype}")
    del again
    refs = A.attention_bwd_reference(q, k, v, out, lse, do)
    errs, tols = {}, {}
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        errs[name] = (got.float() - want.float()).abs().max().item()
        tols[name] = grad_tol(dtype, want.float().abs().max().item())
        check(math.isfinite(errs[name]) and errs[name] <= tols[name],
              f"flash_bwd {name} differs from plain by {errs[name]} (limit "
              f"{tols[name]}) at {shape} {dtype}")
    del grads, refs
    loop = loop_size(8.0 * b * h * n * k.shape[1] * d)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt)

    row = {
        "dq_ms": cuda_ms(torch, lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, dvec),
                         **loop),
        "dkv_ms": cuda_ms(torch, lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                                   dvec), **loop),
        "dq_host_ms": host_ms(torch, lambda: A.flash_attention_bwd_dq(q, k, v, do, lse,
                                                                      dvec)),
        "dkv_host_ms": host_ms(torch, lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                                        dvec)),
        "dq_plain_ms": cuda_ms(torch, lambda: A.attention_bwd_dq_reference(
            q, k, v, do, lse, dvec), **loop),
        "dkv_plain_ms": cuda_ms(torch, lambda: A.attention_bwd_dkv_reference(
            q, k, v, do, lse, dvec), **loop),
        "sdpa_bwd_ms": cuda_ms(torch, sdpa_fwd_bwd, **loop) - cuda_ms(torch, sdpa_fwd,
                                                                      **loop),
        "max_abs_err": errs, "tol": tols,
        "max_err_over_tol": max(errs[x] / tols[x] for x in errs),
    }
    for kind in ("dq", "dkv"):
        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_bwd(
            shape, dtype, qkv.element_size(), kind)
    if dtype == "float32":
        row.update(SCALAR_FP32_BWD.get(shape, {}))
    if (shape, dtype) in EARLIER_BWD_MS:
        row["recorded_earlier_ms"] = EARLIER_BWD_MS[(shape, dtype)]
    emit({"phase": phase, "kernel": "flash_bwd", "shape_bnhd": list(shape[:4]),
          "kv_len": k.shape[1], "dtype": dtype, "route": BWD_ROUTES[route], **row})
    del qkv, q, k, v, do, out, lse, dvec, qt, kt, vt
    torch.cuda.empty_cache()
    return row


@full_fp32
def phase_kernel_c2(torch) -> None:
    """Forward and backward through ``volumetric_attention``'s autograd at
    the C2 shapes in both dtypes, against the plain versions: O and each
    gradient within its limit, one launch of each kernel; then the forward
    and backward kernels and their plain versions timed."""
    from ldm3d_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(9)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for shape in C2_SHAPES:
            b, n, h, d = shape
            qkv, views = _fused_qkv(torch, shape, dt, gen)
            q, k, v = (t.detach().requires_grad_() for t in views)
            do = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dt)
            before = _read_counts()
            out = A.volumetric_attention(q, k, v)
            grads = torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
            after = _read_counts()
            check(all(after[name] == before[name] + 1
                      for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
                  f"C2 case {shape} {dtype}: launches {before} -> {after}")
            qd, kd, vd = q.detach(), k.detach(), v.detach()
            ref, lse = A.attention_reference(qd, kd, vd)
            refs = A.attention_bwd_reference(qd, kd, vd, ref, lse, do)
            errs = {"o": (out.float() - ref.float()).abs().max().item()}
            tols = {"o": out_tol(dtype, ref.float().abs().max().item())}
            for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
                errs[name] = (got.float() - want.float()).abs().max().item()
                tols[name] = grad_tol(dtype, want.float().abs().max().item())
            for name in errs:
                check(math.isfinite(errs[name]) and errs[name] <= tols[name],
                      f"C2 {name} differs from plain by {errs[name]} (limit {tols[name]}) at "
                      f"{shape} {dtype}")
            del grads, refs

            def fwd_bwd():
                torch.autograd.grad(A.volumetric_attention(q, k, v), (q, k, v), do)

            def plain_fwd_bwd():
                o, l = A.attention_reference(qd, kd, vd)
                A.attention_bwd_reference(qd, kd, vd, o, l, do)

            emit({"phase": "kernel_c2", "shape_bnhd": list(shape), "dtype": dtype,
                  "route": {"fwd": FWD_ROUTES[fwd_route(dtype, d)],
                            "bwd": BWD_ROUTES[bwd_route(dtype, d)]},
                  "fwd_ms": cuda_ms(torch, lambda: A.volumetric_attention(qd, kd, vd)),
                  "fwd_plain_ms": cuda_ms(torch, lambda: A.attention_reference(qd, kd, vd)),
                  "fwd_bwd_ms": cuda_ms(torch, fwd_bwd),
                  "fwd_bwd_plain_ms": cuda_ms(torch, plain_fwd_bwd),
                  "fwd_bound_ms": bound(shape, dtype, qkv.element_size())[0],
                  "max_abs_err": errs, "tol": tols,
                  "max_err_over_tol": max(errs[x] / tols[x] for x in errs)})
            del qkv, views, q, k, v, do, out, ref, lse
            torch.cuda.empty_cache()


def _flagship_models(torch, ns, gen):
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn import init_weights_

    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    # the zero-init output conv would hide every layer from the output
    w = unet.conv_out.weight
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
    return ae, unet


def _strided_randn(torch, shape, strides, dt, gen, scale: float = 1.0, shift: float = 0.0):
    """Normal draws (times ``scale``, plus ``shift``) in a tensor of the given
    shape and element strides."""
    t = torch.empty_strided(shape, strides, dtype=dt, device="cuda")
    t.copy_(torch.randn(shape, generator=gen, device="cuda") * scale + shift)
    return t


def _layout_name(torch, shape, strides) -> str:
    t = torch.empty_strided(shape, strides, device="meta")
    if t.is_contiguous(memory_format=torch.channels_last_3d):
        return "channels_last_3d"
    if t.is_contiguous():
        return "contiguous"
    return "strides " + ",".join(str(x) for x in strides)


def _layout_tally(torch, cases: dict, at: int) -> dict:
    """Launches by the layout of the tensor whose strides sit at ``key[at]``."""
    tally: dict[str, int] = {}
    for key, n in cases.items():
        name = _layout_name(torch, key[0], key[at])
        tally[name] = tally.get(name, 0) + n
    return tally


def _gn_check(torch, G, kernel: str, x, dy, mean, inv) -> tuple[float, float]:
    """One GroupNorm-sums kernel against its plain version; returns the
    largest absolute error and the largest error over its limit, and fails
    beyond the limit."""
    dims = tuple(range(2, x.dim()))
    if kernel == "gn_sums":
        got = G.gn_sums(x)
        again = G.gn_sums(x)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"gn_sums gave other sums on a second run at {tuple(x.shape)} {x.dtype}")
        want = G.gn_sums_reference(x)
        xf = x.float()
        terms = (xf, xf * xf)
    else:
        got = G.gn_bwd_sums(dy, x, mean, inv)
        again = G.gn_bwd_sums(dy, x, mean, inv)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"gn_bwd_sums gave other sums on a second run at {tuple(x.shape)} strides "
              f"{x.stride()}, dy strides {dy.stride()} {x.dtype}")
        want = G.gn_bwd_sums_reference(dy, x, mean, inv)
        shape = mean.shape + (1,) * len(dims)
        dyf = dy.float()
        terms = (dyf, dyf * (x.float() - mean.reshape(shape)) * inv.reshape(shape))
    abs_err, worst = 0.0, 0.0
    for g, w, t in zip(got, want, terms):
        tol = GN_REL * t.abs().sum(dim=dims, dtype=torch.float64)
        diff = (g.double() - w.double()).abs()
        abs_err, worst = max(abs_err, diff.max().item()), max(worst, (diff / tol).max().item())
        check(bool((diff <= tol).all()), f"{kernel} differs from plain beyond {GN_REL} of the "
                                         f"absolute sum at {tuple(x.shape)} strides {x.stride()} "
                                         f"{x.dtype}")
    return abs_err, worst


def _library_gn_bwd(torch, dy, x, mean, inv) -> dict:
    """B5's yardstick: ``aten.native_group_norm_backward`` on dy and x viewed
    as one sample of B * C channels, one group a channel, so that its
    per-group mean and rstd are B5's mean_c and inv_c: it returns (dX
    unasked, sum_v dy * x_hat, sum_v dy) per (batch, channel), B5's two sums
    at any batch. The stats and the weight take the first dtype the op takes
    on CUDA (fp32, else x's). Timed on the path's tensors with the NCDHW
    copies that the view needs (``library_ms``; the op reads NCDHW memory),
    and on premade NCDHW copies, the op alone (``library_ncdhw_ms``). Its
    largest difference from the plain version, over GN_REL of the absolute
    sums, says that it computed the same sums."""
    from ldm3d_torch.ops.groupnorm import gn_bwd_sums_reference

    op = torch.ops.aten.native_group_norm_backward
    b, c = x.shape[:2]
    bc, hw = b * c, x[0, 0].numel()
    flat = (1, bc, hw)
    xc, dyc = x.contiguous().view(flat), dy.contiguous().view(flat)
    errors = []
    for stats_dt in (torch.float32, x.dtype):
        m, r = mean.to(stats_dt).view(1, bc), inv.to(stats_dt).view(1, bc)
        w = torch.ones(bc, dtype=stats_dt, device=x.device)
        try:
            _, dgamma, dbeta = op(dyc, xc, m, r, w, 1, bc, hw, bc, [False, True, True])
            torch.cuda.synchronize()
            break
        except RuntimeError as e:
            errors.append(f"{stats_dt}: {str(e).splitlines()[0]}")
    else:
        raise RuntimeError(f"native_group_norm_backward takes none of the stats dtypes: {errors}")
    dims = tuple(range(2, x.dim()))
    shape = mean.shape + (1,) * len(dims)
    dyf = dy.float()
    terms = (dyf, dyf * (x.float() - mean.reshape(shape)) * inv.reshape(shape))
    err = max(((got.view(b, c).double() - want.double()).abs()
               / (GN_REL * t.abs().sum(dim=dims, dtype=torch.float64))).max().item()
              for got, want, t in zip((dbeta, dgamma), gn_bwd_sums_reference(dy, x, mean, inv),
                                      terms))
    del dyf, terms
    rec = {"library_ms": cuda_ms(torch, lambda: op(dy.contiguous().view(flat),
                                                   x.contiguous().view(flat), m, r, w, 1, bc,
                                                   hw, bc, [False, True, True])),
           "library_ncdhw_ms": cuda_ms(torch, lambda: op(dyc, xc, m, r, w, 1, bc, hw, bc,
                                                         [False, True, True])),
           "library_stats_dtype": str(stats_dt).removeprefix("torch."),
           "library_err_over_tol": err}
    if errors:
        rec["library_refused"] = errors
    return rec


# the paths whose GroupNorm inputs kernel_gn times (the kernels line reads
# their totals); the other paths' inputs (distillation, presets, data_tools)
# are checked in both dtypes but not timed: a cut of that phase's depth to
# keep the script inside its time limit
GN_TIMED_PATHS = ("sampling", "training", "training_fp32", "training_ae", "training_ae_fp32",
                  "serving", "parallel_spatial_bf16_step")


def phase_kernel_gn(torch, paths: dict, timed_paths=GN_TIMED_PATHS) -> dict:
    """GroupNorm sums kernels against their plain versions at every input the
    main paths gave them. ``paths`` maps a path's name to the wrappers'
    ``cases`` from its run: {kernel: {(shape, dtype, x strides[, dy
    strides]): launches}}. Each input is rebuilt with its strides, checked in
    bf16 and fp32 (B4 and B5 each giving the same bits on a second run) and,
    when a path of ``timed_paths`` launched it, timed in its own dtype, B5
    beside its library yardstick (:func:`_library_gn_bwd`) and the replaced
    kernels' recorded time (EARLIER_GN_BWD_SUMS); returns the totals over its
    launches of each path whose every input was timed, and the largest
    errors."""
    from ldm3d_torch.ops import groupnorm as G

    gen = torch.Generator(device="cuda").manual_seed(4)
    measured: dict = {}
    errs = {"gn_sums": 0.0, "gn_bwd_sums": 0.0}
    for kernel in ("gn_sums", "gn_bwd_sums"):
        for key in sorted({k for p in paths.values() for k in p[kernel]}, key=str):
            shape, dtype, x_strides = key[:3]
            dy_strides = key[3] if kernel == "gn_bwd_sums" else None
            b, c = shape[:2]
            v = math.prod(shape[2:])
            row: dict = {"max_abs_err": {}, "max_err_over_tol": {}}
            timed = any(paths[p][kernel].get(key) for p in timed_paths if p in paths)
            for check_dtype in (dtype, *({"bfloat16", "float32"} - {dtype})):
                dt = getattr(torch, check_dtype)
                x = _strided_randn(torch, shape, x_strides, dt, gen, 0.5, 0.3)
                dy = None if dy_strides is None else _strided_randn(torch, shape, dy_strides, dt,
                                                                    gen)
                xf = x.float()
                mean = xf.mean(dim=(2, 3, 4))
                inv = torch.rsqrt(xf.var(dim=(2, 3, 4)) + 1e-6)
                del xf
                err, worst = _gn_check(torch, G, kernel, x, dy, mean, inv)
                row["max_abs_err"][check_dtype] = err
                row["max_err_over_tol"][check_dtype] = worst
                errs[kernel] = max(errs[kernel], err)
                if check_dtype == dtype and timed:
                    isz = x.element_size()
                    if kernel == "gn_sums":
                        run = lambda: G.gn_sums(x)  # noqa: E731
                        plain = lambda: G.gn_sums_reference(x)  # noqa: E731
                        row["var_mean_ms"] = cuda_ms(torch, lambda: torch.var_mean(
                            x, dim=(2, 3, 4)))
                        nbytes = b * v * c * isz + 8.0 * b * c
                    else:
                        run = lambda: G.gn_bwd_sums(dy, x, mean, inv)  # noqa: E731
                        plain = lambda: G.gn_bwd_sums_reference(dy, x, mean, inv)  # noqa: E731
                        nbytes = 2.0 * b * v * c * isz + 16.0 * b * c
                        row["recorded_earlier_ms"] = EARLIER_GN_BWD_SUMS["ms"].get(
                            (tuple(shape), dtype))
                        row.update(_library_gn_bwd(torch, dy, x, mean, inv))
                    row.update(ms=cuda_ms(torch, run), host_ms=host_ms(torch, run),
                               plain_ms=cuda_ms(torch, plain),
                               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
                del x, dy, mean, inv
            measured[(kernel, key)] = row
            emit({"phase": "kernel_gn", "kernel": kernel, "shape_bcdhw": list(shape),
                  "dtype_timed": dtype, "x_strides": list(x_strides),
                  "x_layout": _layout_name(torch, shape, x_strides),
                  **({} if dy_strides is None else {
                      "dy_strides": list(dy_strides),
                      "dy_layout": _layout_name(torch, shape, dy_strides)}),
                  "launches": {p: cases[kernel].get(key, 0) for p, cases in paths.items()},
                  **row, "rel_tol": GN_REL, "bound_by": "bytes"})
            torch.cuda.empty_cache()
    totals = {}
    for path, kernels in paths.items():
        for kernel, cases in kernels.items():
            if not cases:
                continue
            rows = [(n, measured[(kernel, key)]) for key, n in cases.items()]
            if not all("ms" in r for _, r in rows):  # not timed: its launches only
                emit({"phase": "kernel_gn_path", "path": path, "kernel": kernel,
                      "launches": sum(cases.values()), "distinct_inputs": len(cases),
                      "timed": False})
                continue
            tot = {k: sum(n * r[k] for n, r in rows)
                   for k in ("ms", "host_ms", "plain_ms", "bound_ms", "var_mean_ms", "library_ms",
                             "library_ncdhw_ms")
                   if all(k in r for _, r in rows)}
            tot["launches"] = sum(cases.values())
            tot["ms_per_call"] = tot["ms"] / tot["launches"]
            tot["host_ms_per_call"] = tot["host_ms"] / tot["launches"]
            tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
            if kernel == "gn_sums" and path in PR5_GN_SUMS:
                tot["pr5"] = PR5_GN_SUMS[path]
            if kernel == "gn_bwd_sums" and path in EARLIER_GN_BWD_SUMS["paths"]:
                tot["recorded_earlier"] = EARLIER_GN_BWD_SUMS["paths"][path]
            totals[(path, kernel)] = tot
            emit({"phase": "kernel_gn_path", "path": path, "kernel": kernel, **tot,
                  "distinct_inputs": len(cases), "x_layouts": _layout_tally(torch, cases, 2),
                  **({"dy_layouts": _layout_tally(torch, cases, 3)}
                     if kernel == "gn_bwd_sums" else {})})
    return {"totals": totals, "max_abs_err": errs}


def _kernel_gn_all(torch, paths: dict) -> dict:
    """kernel_gn over ``paths``, every input timed (a phase run alone)."""
    return phase_kernel_gn(torch, paths, timed_paths=tuple(paths))


def _host_us(fn, calls: int = 200, reps: int = 5) -> float:
    """Host microseconds per call of ``fn``, the median of ``reps`` loops."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
    return statistics.median(times)


def phase_gn_host(torch) -> dict:
    """What the forward GroupNorm wrapper's host time a call goes to, piece by
    piece, at a batch-1 UNet input (1, 1024, 5, 5, 5) fp32: the whole call,
    then each step it takes alone, and the steps PR 5's wrapper took that
    this one does not (a device guard around the current stream, a ctypes
    stride array); then the backward wrapper's own steps at a stage-1 input
    (:func:`_gn_bwd_host`)."""
    import ctypes

    from ldm3d_torch.ops import groupnorm as G
    from ldm3d_torch.ops._kernels import groupnorm_library

    x = torch.randn((1, 1024, 5, 5, 5), device="cuda").contiguous(
        memory_format=torch.channels_last_3d)
    G.gn_sums(x)
    b, v, c = G._check(x)
    key = (x.shape, x.stride(), x.dtype, x.data_ptr() % 16)
    plan = G._PLANS[key]
    out = torch.empty((2, b, c), device="cuda")
    partials, counters = G._WS.get(x.device, plan)
    fn = groupnorm_library().ldm3d_gn_sums
    stream = torch._C._cuda_getCurrentRawStream(0)
    dev = x.device
    torch.cuda.synchronize()

    def launch():
        fn(x.data_ptr(), out.data_ptr(), partials.data_ptr(), counters.data_ptr(), 0, b, v, c,
           plan.sb, plan.sv, plan.vec, plan.ct, plan.nsplit, plan.chunk, int(plan.cluster),
           stream)

    def old_guard_and_stream():
        with torch.cuda.device(dev):
            torch.cuda.current_stream(dev).cuda_stream

    pieces = {
        "whole_call": lambda: G.gn_sums(x),
        "plan_lookup": lambda: G._PLANS.get((x.shape, x.stride(), x.dtype, x.data_ptr() % 16)),
        "checks_and_plan_on_a_new_input": lambda: G.gn_sums_plan(*G._check(x), x.dtype,
                                                                 G._x_strides(x), 0),
        "output_allocation": lambda: torch.empty((2, b, c), device=dev),
        "workspace": lambda: G._WS.get(dev, plan),
        "current_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "current_device_check": lambda: dev.index != torch.cuda.current_device(),
        "ctypes_call_and_launch": launch,
        "cases_key": lambda: (tuple(x.shape), "float32", x.stride()),
        "output_unbind": lambda: out.unbind(0),
        "pr5_device_guard_and_current_stream": old_guard_and_stream,
        "pr5_ctypes_stride_array": lambda: (ctypes.c_int64 * 3)(*x.stride()[:3]),
    }
    rec = {name: _host_us(f) for name, f in pieces.items()}
    torch.cuda.synchronize()
    emit({"phase": "gn_host", "shape_bcdhw": list(x.shape), "dtype": "float32",
          "host_us": rec, "pr5_host_us_per_call": PR5_GN_SUMS["host_ms_per_call"] * 1e3})
    return {"gn_sums": rec, "gn_bwd_sums": _gn_bwd_host(torch)}


def _gn_bwd_host(torch) -> dict:
    """The backward GroupNorm wrapper's host time a call, piece by piece, at
    a stage-1 input, (1, 256, 16, 16, 16) bf16 with x and dy channels_last_3d:
    the whole call and each step it takes alone; the rest of the call is
    its checks of mean and inv and its launch count. The replaced wrapper's
    host time is the recorded figure beside it."""
    from ldm3d_torch.ops import groupnorm as G

    shape = (1, 256, 16, 16, 16)
    x, dy = (torch.randn(shape, device="cuda").to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d) for _ in range(2))
    mean, inv = torch.zeros(shape[:2], device="cuda"), torch.ones(shape[:2], device="cuda")
    G.gn_bwd_sums(dy, x, mean, inv)
    dev = x.device
    plan = G.gn_bwd_sums_plan_of(dy, x, mean, inv)
    out = torch.empty((2, plan.b, plan.c), device="cuda")
    torch.cuda.synchronize()
    pieces = {
        "whole_call": lambda: G.gn_bwd_sums(dy, x, mean, inv),
        "plan_lookup": lambda: G.gn_bwd_sums_plan_of(dy, x, mean, inv),
        "checks_and_plan_on_a_new_input": lambda: G.gn_bwd_sums_plan_of(dy, x, mean, inv,
                                                                        cached=False),
        "output_allocation": lambda: torch.empty((2, plan.b, plan.c), device=dev),
        "workspace_stream_and_launch": lambda: G._launch_bwd_sums(
            plan, dy.data_ptr(), x.data_ptr(), mean, inv, out, x.dtype, dev),
        "cases_key": lambda: (tuple(x.shape), "bfloat16", x.stride(), dy.stride()),
        "output_unbind": lambda: out.unbind(0),
    }
    rec = {name: _host_us(f) for name, f in pieces.items()}
    torch.cuda.synchronize()
    earlier = EARLIER_GN_BWD_SUMS["paths"]["training_ae"]
    emit({"phase": "gn_bwd_host", "shape_bcdhw": list(shape), "dtype": "bfloat16",
          "host_us": rec,
          "recorded_earlier_stage1_host_us_per_call": earlier["host_ms"] / 396 * 1e3,
          "recorded_earlier_host_us_this_input":
              EARLIER_GN_BWD_SUMS["host_ms"][(shape, "bfloat16")] * 1e3})
    return rec


def _write_env(model_dir: Path, **extra) -> Path:
    env = {"model_dir": str(model_dir), "output_dir": str(model_dir / "out"), "seed": 0,
           "synthetic_data": True, "tfevent_path": str(model_dir / "tb"), **extra}
    path = model_dir / "environment.json"
    path.write_text(json.dumps(env))
    return path


def _module_counts(torch, ns) -> dict:
    """GroupNorms (the discriminator's instance norms among them) and
    attention blocks per model part, from models built on the meta device."""
    from ldm3d_torch.cli.train_autoencoder import build_discriminator
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn.blocks import AttentionBlock3D, GroupNorm32
    from ldm3d_torch.nn.discriminator import _InstanceNorm

    with torch.device("meta"):
        ae = define_instance(ns, "autoencoder_def")
        unet = define_instance(ns, "diffusion_def")
        disc = build_discriminator(ns)

    def count(module, cls):
        return sum(isinstance(m, cls) for m in module.modules())

    parts = (("encoder", ae.encoder), ("decoder", ae.decoder), ("unet", unet),
             ("discriminator", disc))
    return {part: {"gn": count(mod, (GroupNorm32, _InstanceNorm)),
                   "attn": count(mod, AttentionBlock3D)} for part, mod in parts}


def _reset_counts() -> None:
    from ldm3d_torch.ops import attention as A
    from ldm3d_torch.ops import conv3d as C
    from ldm3d_torch.ops import groupnorm as G

    for fn in (A.flash_attention_fwd, A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv,
               G.gn_sums, G.gn_bwd_sums, C.conv3d_igemm):
        fn.launches = 0
    A.flash_attention_fwd.route_launches = dict.fromkeys(A.FWD_ROUTE_IDS, 0)
    for fn in (A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv):
        fn.route_launches = dict.fromkeys(A.BWD_ROUTE_IDS, 0)
    G.gn_sums.cases, G.gn_bwd_sums.cases = {}, {}
    for fn in (A.flash_attention_fwd, A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv):
        fn.cases = {}


def _read_counts() -> dict:
    from ldm3d_torch.ops.graphs import launch_counts

    return _counts_by_key(launch_counts())


def _counts_by_key(counts: dict) -> dict:
    """Launch counts of every wrapper (``ldm3d_torch.ops.graphs.launch_counts``,
    or a ``launch_delta`` of two), by kernel and route."""
    def fwd(route):
        return counts["flash_attention_fwd"]["route_launches"].get(route, 0)

    def bwd(kind, route):
        return counts[f"flash_attention_bwd_{kind}"]["route_launches"].get(route, 0)

    return {"flash_fwd": counts["flash_attention_fwd"]["launches"],
            "flash_fwd_wgmma": fwd("bf16_wgmma"),
            "flash_bwd_dq": counts["flash_attention_bwd_dq"]["launches"],
            "flash_bwd_dq_wgmma": bwd("dq", "bf16_wgmma"),
            "flash_bwd_dkv": counts["flash_attention_bwd_dkv"]["launches"],
            "flash_bwd_dkv_wgmma": bwd("dkv", "bf16_wgmma"),
            "flash_fwd_fp32": fwd("fp32"),
            "flash_bwd_dq_mma": bwd("dq", "bf16"), "flash_bwd_dkv_mma": bwd("dkv", "bf16"),
            "flash_bwd_dq_fp32": bwd("dq", "fp32"), "flash_bwd_dkv_fp32": bwd("dkv", "fp32"),
            "gn_sums": counts["gn_sums"]["launches"],
            "gn_bwd_sums": counts["gn_bwd_sums"]["launches"],
            "conv3d_igemm": counts["conv3d_igemm"]["launches"]}


def _read_gn_cases() -> dict:
    """The GroupNorm wrappers' launches by input since the last reset."""
    from ldm3d_torch.ops import groupnorm as G

    return {"gn_sums": dict(G.gn_sums.cases), "gn_bwd_sums": dict(G.gn_bwd_sums.cases)}


def _flagship_checkpoints(torch, ns, workdir: Path) -> tuple[Path, tuple[int, int]]:
    """The full-width models with seeded random weights, saved as the CLIs'
    two-stage checkpoints under ``workdir / "flagship"``; returns the
    directory and the (UNet, VAE) parameter counts."""
    from ldm3d_torch.cli.common import save_two_stage

    ae, unet = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(1))
    model_dir = workdir / "flagship"
    save_two_stage(str(model_dir), ae, unet, scale_factor=0.8)
    n_params = sum(p.numel() for p in unet.parameters()), sum(p.numel() for p in ae.parameters())
    del ae, unet
    torch.cuda.empty_cache()
    return model_dir, n_params


def phase_main_path(torch, ns, counts, workdir: Path, card: str, smi_line: str) -> dict:
    """Full-width conditional DDIM-50 through the CLI; returns the launch
    counts and the GroupNorm wrappers' inputs of the timed run."""
    from ldm3d_torch.cli.inference import main as inference_main
    from ldm3d_torch.configs import preset_path
    from ldm3d_torch.utils.nifti import read_nifti

    t0 = time.perf_counter()
    cfg_path = preset_path("config_train_32g.json")
    model_dir, n_params = _flagship_checkpoints(torch, ns, workdir)
    setup_s = time.perf_counter() - t0

    env = _write_env(model_dir)
    argv = ["-c", cfg_path, "-e", str(env), "-n", "1", "--sampler", "ddim",
            "--steps", str(DDIM_STEPS), "--amp"]
    inference_main(argv)  # warm-up run: cuDNN plans, allocator, kernel attributes
    shutil.rmtree(model_dir / "out")

    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    unpin_precision(torch)
    written = inference_main(argv, timings=timings)
    launches, gn_cases = _read_counts(), _read_gn_cases()
    flags = pinned_precision(torch, "cli.inference.main")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(len(written) == 1, f"expected one volume, got {written}")
    vol, _ = read_nifti(written[0])
    check(vol.shape == (80, 80, 80), f"volume shape {vol.shape} != (80, 80, 80)")
    check(bool(np.isfinite(vol).all()), "the sampled volume holds non-finite values")
    expected = sum(LAUNCHES_PER_SAMPLE.values())
    check(launches["flash_fwd"] == expected,
          f"attention kernel launched {launches['flash_fwd']} times, expected {expected}")
    # the VAE's d = 256 attentions (encoder and decoder) take the wgmma route
    expected_wg = counts["encoder"]["attn"] + counts["decoder"]["attn"]
    check(launches["flash_fwd_wgmma"] == expected_wg == LAUNCHES_PER_SAMPLE[MAIN_SHAPES[2]],
          f"the wgmma forward launched {launches['flash_fwd_wgmma']} times, expected "
          f"{expected_wg}")
    expected_gn = (counts["encoder"]["gn"] + DDIM_STEPS * counts["unet"]["gn"]
                   + counts["decoder"]["gn"])
    check(launches["gn_sums"] == expected_gn,
          f"GroupNorm sums kernel launched {launches['gn_sums']} times, expected {expected_gn}")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == launches["gn_bwd_sums"]
          == launches["conv3d_igemm"] == 0,
          f"a backward or conv kernel ran during sampling: {launches}")
    encode_ms, denoise_ms, decode_ms = (timings[k][0] for k in ("encode_ms", "denoise_ms",
                                                                 "decode_ms"))
    emit({"phase": "main_path", "config": "config_train_32g.json", "volume": list(vol.shape),
          "sampler": f"ddim-{DDIM_STEPS}", "dtype": "bfloat16", "batch": 1,
          "unet_params": n_params[0], "autoencoder_params": n_params[1],
          "setup_s": round(setup_s, 3), "encode_ms": encode_ms,
          "denoise_ms_per_step": denoise_ms / DDIM_STEPS, "decode_ms": decode_ms,
          "volumes_per_s": 1e3 / (denoise_ms + decode_ms),
          "volumes_per_s_with_encode": 1e3 / (encode_ms + denoise_ms + decode_ms),
          "launches": launches, "expected_gn_sums": expected_gn,
          "peak_device_memory_gib": peak_gib, "volume_min": float(vol.min()),
          "volume_max": float(vol.max()), "allow_tf32": flags, "card": card,
          "nvidia_smi": smi_line})
    shutil.rmtree(model_dir / "out")
    timings = {}
    steps_at = argv.index("--steps") + 1
    prof_argv = [*argv[:steps_at], str(PROFILE_DDIM_STEPS), *argv[steps_at + 1:]]
    prof, _ = _profiled(torch, lambda: inference_main(prof_argv, timings=timings))
    window_ms = sum(timings[k][0] for k in ("encode_ms", "denoise_ms", "decode_ms"))
    emit({"phase": "profile", "path": f"sampling (DDIM-{PROFILE_DDIM_STEPS})",
          **_profile_summary(torch, prof, window_ms)})
    shutil.rmtree(model_dir)
    return launches, gn_cases


# --fused-decode runs (sample_fused phase): name -> (sampler, steps or None for
# the full schedule, --amp, batch, guidance); each held bit for bit to the
# eager CLI with the same argv and seed
FUSED_RUNS = {"a_ddim50_bf16": ("ddim", DDIM_STEPS, True, 1, 1.0),
              "b_ddpm50_fp32_b2_cfg": ("ddpm", 50, False, 2, 2.0),
              "c_dpm3_20_bf16": ("dpm3", 20, True, 1, 1.0),
              "d_ddpm100_bf16": ("ddpm", None, True, 1, 1.0)}
# the full-schedule run's schedule: the config's NoiseScheduler cut from 1,000
# steps to these (its eager twin took 48.6 s of the script's time limit at
# 1,000; 250 until the parallel phase needed the time); the models and the
# volume stay the flagship's
FULL_SCHEDULE_STEPS = 100
# the profiled fused sample: DDIM-10, as the eager main path's profile
PROFILE_FUSED_STEPS = 10


def _cli_volumes(written) -> np.ndarray:
    from ldm3d_torch.utils.nifti import read_nifti

    return np.stack([read_nifti(path)[0] for path in written])


def phase_sample_fused(torch, ns, counts, workdir: Path, card: str, smi_line: str) -> None:
    """``cli.inference --fused-decode`` on the full-width models (the main
    path's seeded checkpoints) in each of FUSED_RUNS, after its eager twin
    (the same argv and seed without the flag): the volumes equal bit for
    bit; the twin's launches those its sampler implies (attention forwards
    and B4 per UNet call and per VAE part, no backward or conv kernel), and
    the fused run's the same once its warm-up's are taken off; the step and
    decode captured once per run (one step graph, two for ddpm, whose last
    step adds no noise). Then one fused DDIM-10 sample profiled (the second
    of ``-n 2``, so that the capture is outside the window)."""
    from ldm3d_torch.configs import preset_path
    from ldm3d_torch.diffusion import inferer

    model_dir, _ = _flagship_checkpoints(torch, ns, workdir)
    env = _write_env(model_dir)
    cfg_path = preset_path("config_train_32g.json")
    unet_attn = counts["unet"]["attn"]
    vae_attn = counts["encoder"]["attn"] + counts["decoder"]["attn"]
    # the CLI's own peak is its checkpoint load (state dict and model both on
    # the card); sampling's is taken from the start of the eager loop, or of
    # the captured sampler's construction, to the end of the call
    mem: dict = {}

    def from_here(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            mem["base"] = torch.cuda.memory_allocated()
            mem["base_reserved"] = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            return fn(*args, **kwargs)
        return run

    patched = {(inferer, "sample_latents"): inferer.sample_latents,
               (inferer.CapturedSampler, "__init__"): inferer.CapturedSampler.__init__}
    for (owner, attr), fn in patched.items():
        setattr(owner, attr, from_here(fn))
    try:
        _sample_fused_runs(torch, ns, counts, model_dir, env, cfg_path, unet_attn, vae_attn,
                           mem, card, smi_line)
    finally:
        for (owner, attr), fn in patched.items():
            setattr(owner, attr, fn)
    _profile_fused_sample(torch, model_dir, env, cfg_path)
    shutil.rmtree(model_dir)


def _sample_fused_runs(torch, ns, counts, model_dir, env, cfg_path, unet_attn, vae_attn, mem,
                       card, smi_line) -> None:
    from ldm3d_torch.cli.inference import main as inference_main
    from ldm3d_torch.ops import graphs

    for name, (sampler, steps, amp, batch, guidance) in FUSED_RUNS.items():
        run_cfg = cfg_path
        if not steps:  # the full schedule, cut to FULL_SCHEDULE_STEPS
            cfg = json.loads(Path(cfg_path).read_text())
            cfg["NoiseScheduler"]["num_train_timesteps"] = FULL_SCHEDULE_STEPS
            run_cfg = str(model_dir / "config_full_schedule.json")
            Path(run_cfg).write_text(json.dumps(cfg))
        argv = ["-c", run_cfg, "-e", str(env), "-n", "1", "--sampler", sampler,
                "--batch", str(batch), "--guidance", str(guidance)]
        argv += ["--steps", str(steps)] if steps else []
        argv += ["--amp"] if amp else []
        n_steps = steps or FULL_SCHEDULE_STEPS
        runs = {}
        for way, extra in (("eager", []), ("fused", ["--fused-decode"])):
            timings: dict = {}
            gc.collect()  # the last CLI run's models and graphs
            torch.cuda.empty_cache()
            before = graphs.launch_counts()
            unpin_precision(torch)
            t0 = time.perf_counter()
            written = inference_main(argv + extra, timings=timings)
            wall_s = time.perf_counter() - t0
            flags = pinned_precision(torch, f"cli.inference.main {' '.join(extra)}")
            delta = graphs.launch_delta(graphs.launch_counts(), before)
            vols = _cli_volumes(written)
            shutil.rmtree(model_dir / "out")
            runs[way] = {"timings": timings, "delta": delta, "vols": vols, "wall_s": wall_s,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "sampling_peak_gib": (torch.cuda.max_memory_allocated()
                                               - mem["base"]) / 2**30,
                         "sampling_reserved_gib": (torch.cuda.max_memory_reserved()
                                                   - mem["base_reserved"]) / 2**30,
                         "allow_tf32": flags}
        eager, fused = runs["eager"], runs["fused"]
        check(eager["vols"].shape == (batch, 80, 80, 80), f"{name}: volumes "
                                                          f"{eager['vols'].shape}")
        check(bool(np.isfinite(fused["vols"]).all()), f"{name}: non-finite fused volume")
        same = bool(np.array_equal(fused["vols"], eager["vols"]))
        check(same, f"{name}: the fused volumes differ from the eager CLI's by up to "
                    f"{float(np.abs(fused['vols'] - eager['vols']).max())}")
        warmup = fused["timings"]["warmup_launches"][0]
        sample_delta = graphs.launch_delta(fused["delta"], warmup)
        check(sample_delta == eager["delta"],
              f"{name}: the fused sample's launches {_counts_by_key(sample_delta)} differ from "
              f"the eager one's {_counts_by_key(eager['delta'])}")
        launches = _counts_by_key(eager["delta"])
        expected = {"flash_fwd": n_steps * unet_attn + vae_attn,
                    "flash_fwd_wgmma": vae_attn if amp else 0,
                    "gn_sums": (counts["encoder"]["gn"] + n_steps * counts["unet"]["gn"]
                                + counts["decoder"]["gn"])}
        for key, want in expected.items():
            check(launches[key] == want, f"{name}: {key} launched {launches[key]} times a "
                                         f"sample, expected {want}")
        check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == launches["gn_bwd_sums"]
              == launches["conv3d_igemm"] == 0, f"{name}: a backward or conv kernel ran: "
                                                f"{launches}")
        graphs_captured = fused["timings"]["capture_graphs"][0]
        check(graphs_captured == (3 if sampler == "ddpm" else 2),
              f"{name}: {graphs_captured} graphs captured")
        t_f, t_e = fused["timings"], eager["timings"]
        emit({"phase": "sample_fused", "run": name, "config": "config_train_32g.json",
                "sampler": f"{sampler}-{n_steps}", "dtype": "bfloat16" if amp else "float32",
                "batch": batch, "guidance": guidance, "bit_equal_to_eager": same,
                "graphs_captured": graphs_captured, "capture_ms": t_f["capture_ms"][0],
                "denoise_ms_per_step": t_f["denoise_ms"][0] / n_steps,
                "decode_ms": t_f["decode_ms"][0],
                "replay_volumes_per_s": 1e3 * batch / (t_f["denoise_ms"][0]
                                                       + t_f["decode_ms"][0]),
                "sample_ms": t_f["sample_ms"][0], "eager_sample_ms": t_e["sample_ms"][0],
                "volumes_per_s": 1e3 * batch / t_f["sample_ms"][0],
                "eager_volumes_per_s": 1e3 * batch / t_e["sample_ms"][0],
                "eager_denoise_ms_per_step": t_e["denoise_ms"][0] / n_steps,
                "eager_decode_ms": t_e["decode_ms"][0],
                "peak_device_memory_gib": fused["peak_gib"],
                "eager_peak_device_memory_gib": eager["peak_gib"],
                "sampling_peak_gib": fused["sampling_peak_gib"],
                "eager_sampling_peak_gib": eager["sampling_peak_gib"],
                "sampling_reserved_gib": fused["sampling_reserved_gib"],
                "eager_sampling_reserved_gib": eager["sampling_reserved_gib"],
                "peak_note": "max_memory_allocated from the start of the eager loop, or of "
                             "the captured sampler's construction, to the end of the CLI call "
                             "(the models included); sampling_peak_*: less what was allocated "
                             "at that start; sampling_reserved_*: the allocator's reserved "
                             "memory likewise, which holds the graphs' pool (a replay's "
                             "intermediates are not allocated tensors)",
                "cli_wall_s": fused["wall_s"], "eager_cli_wall_s": eager["wall_s"],
                "launches_a_sample": launches, "warmup_launches": _counts_by_key(warmup),
                "replay_sync_debug_mode": "error", "allow_tf32": fused["allow_tf32"],
                "timing_note": "denoise and decode ms: fused, device ms from CUDA events "
                               "around the replays (the step noises' draws and copy left "
                               "out: replay_volumes_per_s); eager, host ms to a device sync. "
                               "sample_ms and volumes_per_s, both ways: host ms from before "
                               "the eager loop, or the fused step noises' draws, to the end "
                               "of the decode, to a device sync (the capture, before the "
                               "first sample, left out)", "card": card, "nvidia_smi": smi_line})



def _profile_fused_sample(torch, model_dir, env, cfg_path) -> None:
    """One fused DDIM-10 sample under the profiler: the second replay run of
    ``-n 2``, the capture and the first sample outside the window."""
    from ldm3d_torch.cli.inference import main as inference_main
    from ldm3d_torch.diffusion import inferer

    sampler, steps = "ddim", PROFILE_FUSED_STEPS
    argv = ["-c", cfg_path, "-e", str(env), "-n", "2", "--sampler", sampler, "--steps",
            str(steps), "--amp", "--fused-decode"]
    replay = inferer.CapturedSampler._replay
    seen: dict = {}

    def timed_replay(self, decode):
        t0 = time.perf_counter()
        replay(self, decode)  # ends on the device's last event
        seen["window_ms"] = (time.perf_counter() - t0) * 1e3

    def profiled_replay(self, decode):
        seen["calls"] = seen.get("calls", 0) + 1
        if seen["calls"] < 2:
            return replay(self, decode)
        seen["prof"], _ = _profiled(torch, lambda: timed_replay(self, decode))
        seen["last_ms"] = dict(self.last_ms)

    inferer.CapturedSampler._replay = profiled_replay
    try:
        inference_main(argv)
    finally:
        inferer.CapturedSampler._replay = replay
    shutil.rmtree(model_dir / "out")
    check("prof" in seen, "the fused sample was not profiled")
    emit({"phase": "profile", "path": "sampling_fused", "sampler": f"ddim-{steps}",
          "sample_device_ms": seen["last_ms"],
          "filing_note": "a replayed kernel has no enclosing aten op: every kernel is filed "
                         "by its name", **_profile_summary(torch, seen["prof"],
                                                          seen["window_ms"])})


# A device kernel launched inside one of these aten ops is filed under the
# outermost such op that encloses it, whatever the kernel's name: cuDNN may
# run a 1x1 conv as a GEMM, and a Dense's bias add is part of the Dense.
OP_CATEGORIES = (
    ("convolution", ("aten::conv3d", "aten::convolution", "aten::convolution_backward")),
    ("matmul (Dense)", ("aten::linear", "aten::addmm", "aten::mm", "aten::matmul")),
    ("dtype casts (weights; GroupNorm coefficients)", ("aten::to", "aten::_to_copy")),
    ("optimizer (AdamW)", ("Optimizer.step#AdamW.step",)),
)
# A convolution op whose input is 4-D is a 2D convolution: LPIPS's SqueezeNet
# (filed so only when the profile recorded the ops' input shapes)
CONV2D_CATEGORY = "convolution 2D (LPIPS)"
# Any other kernel (the port's own kernels, launched through ctypes outside
# any aten op, among them) by its name; first match wins.
KERNEL_CATEGORIES = (
    ("attention forward (flash_fwd)", ("flash_fwd_",)),
    ("attention backward (flash_bwd)", ("flash_bwd_dq_", "flash_bwd_dkv_")),
    ("GroupNorm sums forward (B4, gn_sums_onepass)", ("gn_sums_onepass",)),
    ("GroupNorm sums backward (B5, gn_bwd_sums_onepass)", ("gn_bwd_sums_onepass",)),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "winograd", "implicit")),
    ("matmul (Dense)", ("gemm", "gemv", "nvjet", "cublas", "cutlass", "splitk")),
    ("reduction", ("reduce",)),
    ("elementwise (GroupNorm affine and backward, SiLU, adds, clip)",
     ("elementwise", "vectorized")),
    ("layout and copies (cat, pad, upsample)", ("cat", "copy", "pad", "upsample", "nearest")),
)


def _op_category(ev) -> str | None:
    """Category of the outermost op of OP_CATEGORIES enclosing ``ev``; a
    convolution whose input is 4-D is CONV2D_CATEGORY."""
    cat = None
    while ev is not None:
        found = next((c for c, ops in OP_CATEGORIES if ev.name in ops), None)
        if found == "convolution" and ev.input_shapes and len(ev.input_shapes[0]) == 4:
            found = CONV2D_CATEGORY
        cat = found or cat
        ev = ev.cpu_parent
    return cat


def _is_memory_op(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _profiled(torch, fn, record_shapes: bool = False):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        out = fn()
    return prof, out


def _device_kernel_count(torch, prof, patterns) -> int:
    """Launches of the device kernels whose names hold any of ``patterns``."""
    from torch.autograd import DeviceType

    return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
               and any(p in ev.key for p in patterns))


def _busy_ms(spans) -> float:
    """ms in which at least one of the (start, end) spans (us) runs."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _profile_summary(torch, prof, window_ms: float) -> dict:
    """Device time by kernel category over a profiled window and the
    device's idle share of it (the profiler's own overhead is inside): busy
    is the time in which at least one kernel ran, from the kernels' device
    timestamps, so kernels that overlap count once; the category sums add
    each kernel's own duration."""
    from torch.autograd import DeviceType

    by_cat: dict[str, float] = {}
    names_by_cat: dict[str, dict[str, float]] = {}

    def add(cat: str, name: str, ms: float) -> None:
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        names = names_by_cat.setdefault(cat, {})
        names[name[:200]] = names.get(name[:200], 0.0) + ms

    # a host range (such as Optimizer.step#AdamW.step) is mirrored on the
    # device's track as a span over its kernels: it is not a kernel
    averages = prof.key_averages()
    host_names = {ev.key for ev in averages if ev.device_type == DeviceType.CPU}
    device_events = [ev for ev in averages if ev.device_type == DeviceType.CUDA
                     and not _is_memory_op(ev.key) and ev.key not in host_names]
    device_names = {ev.key for ev in device_events}
    by_op: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        cat = _op_category(ev)
        if cat is None:
            continue
        for kern in ev.kernels:
            if kern.name in device_names:
                add(cat, kern.name, kern.duration / 1e3)
                by_op[kern.name] = by_op.get(kern.name, 0.0) + kern.duration / 1e3
    attributed_ms = sum(by_op.values())
    kernels = []
    for ev in device_events:
        ms = getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0)) / 1e3
        kernels.append((ms, ev.count, ev.key[:200]))
        rest = ms - by_op.get(ev.key, 0.0)
        if rest > 1e-6:
            low = ev.key.lower()
            add(next((c for c, pats in KERNEL_CATEGORIES if any(p.lower() in low for p in pats)),
                     "other"), ev.key, rest)
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and ev.name in device_names]
    check(spans, "the profiler saw no device kernels")
    busy = _busy_ms(spans)
    return {"window_ms": window_ms, "device_busy_ms": busy,
            "device_kernel_ms": sum(by_cat.values()),
            "device_span_ms": (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3,
            "device_idle_share": 1.0 - busy / window_ms,
            "device_ms_filed_by_op": attributed_ms,
            "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            "top_kernels_by_category": {
                cat: [{"ms": ms, "name": name} for name, ms in
                      sorted(names.items(), key=lambda kv: -kv[1])[:3]]
                for cat, names in names_by_cat.items()},
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in sorted(kernels, reverse=True)[:12]]}


def phase_train(torch, ns, counts, workdir: Path, card: str, smi_line: str,
                amp: bool = True) -> dict:
    """Full-width stage-2 training through the CLI, in bf16 with ``--amp``
    or in fp32 without it; returns its record."""
    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.cli.train_diffusion import main as train_main
    from ldm3d_torch.configs import define_instance, preset_path

    t0 = time.perf_counter()
    dtype = "bfloat16" if amp else "float32"
    cfg_path = preset_path("config_train_32g.json")
    model_dir = workdir / f"train_{dtype}"
    ae, unet = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(5))
    CheckpointManager(str(model_dir), "autoencoder").save("best", {"state_dict": ae.state_dict()})
    del ae, unet
    torch.cuda.empty_cache()
    env = _write_env(model_dir, synthetic_num=TRAIN_PAIRS, resume_ckpt=False)
    setup_s = time.perf_counter() - t0

    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    unpin_precision(torch)
    t_run = time.perf_counter()
    best_val = train_main(["-c", cfg_path, "-e", str(env), *(["--amp"] if amp else []),
                           "--no-images", "--max-epochs", "1"], timings=timings)
    run_s = time.perf_counter() - t_run
    launches, gn_cases = _read_counts(), _read_gn_cases()
    flags = pinned_precision(torch, "cli.train_diffusion.main")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    steps = len(timings["train_step_ms"])
    val_batches = sum(timings["val_batches"])
    check(steps >= 4, f"expected at least 4 train steps, got {steps}")
    losses = timings["diffusion_loss"]
    check(all(math.isfinite(x) for x in losses) and math.isfinite(best_val),
          f"non-finite losses: train {losses}, val {best_val}")
    # exact launches: one scale-factor encode, two encodes and a UNet forward
    # and backward per step, two encodes and a UNet forward per val batch
    encodes = 1 + 2 * steps + 2 * val_batches
    expected = {
        "flash_fwd": encodes * counts["encoder"]["attn"] + (steps + val_batches)
        * counts["unet"]["attn"],
        # the encoder's d = 256 attention: the bf16 wgmma route, or fp32
        "flash_fwd_wgmma": encodes * counts["encoder"]["attn"] if amp else 0,
        "flash_bwd_dq": steps * counts["unet"]["attn"],
        "flash_bwd_dkv": steps * counts["unet"]["attn"],
        # the UNet's d = 64 attention: every backward launch on the bf16
        # wgmma route, or on fp32's
        "flash_bwd_dq_wgmma": steps * counts["unet"]["attn"] if amp else 0,
        "flash_bwd_dkv_wgmma": steps * counts["unet"]["attn"] if amp else 0,
        "gn_sums": encodes * counts["encoder"]["gn"] + (steps + val_batches) * counts["unet"]["gn"],
        "gn_bwd_sums": steps * counts["unet"]["gn"],
        "conv3d_igemm": 0,
    }
    for name, n in expected.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times in training, "
                                   f"expected {n}")
    per_step = {
        "flash_fwd": 2 * counts["encoder"]["attn"] + counts["unet"]["attn"],
        "flash_fwd_wgmma": 2 * counts["encoder"]["attn"] if amp else 0,
        "flash_bwd_dq": counts["unet"]["attn"], "flash_bwd_dkv": counts["unet"]["attn"],
        "flash_bwd_dq_wgmma": counts["unet"]["attn"] if amp else 0,
        "flash_bwd_dkv_wgmma": counts["unet"]["attn"] if amp else 0,
        "gn_sums": 2 * counts["encoder"]["gn"] + counts["unet"]["gn"],
        "gn_bwd_sums": counts["unet"]["gn"],
    }

    # the checkpoints exist and reload: best = last's params, last's step
    ckpt = CheckpointManager(str(model_dir), "diffusion")
    check(ckpt.exists("best") and ckpt.exists("last"), "diffusion best/last not written")
    best = ckpt.load("best", map_location="cpu")
    last = ckpt.load("last", map_location="cpu")
    with torch.device("meta"):
        reloaded = define_instance(ns, "diffusion_def")
    reloaded.load_state_dict(best["state_dict"], assign=True)
    check(last["step"] == steps, f"last checkpoint at step {last['step']}, ran {steps}")
    check(all(torch.equal(best["state_dict"][k], v) for k, v in last["params"].items()),
          "best and last params differ after one validated epoch")
    check(all(bool(torch.isfinite(p).all()) for p in reloaded.parameters()),
          "reloaded diffusion params hold non-finite values")
    check(abs(best["meta"]["scale_factor"] - timings["scale_factor"]) == 0,
          "best checkpoint's scale_factor differs from the run's")
    del best, last, reloaded

    step_ms = timings["train_step_ms"][1:]
    median_ms = statistics.median(step_ms)
    record = {"steps": steps, "val_batches": val_batches, "launches": launches,
              "expected_launches": expected, "launches_per_step": per_step,
              "train_step_ms": timings["train_step_ms"], "median_step_ms_after_warmup": median_ms,
              "volumes_per_s_trained": TRAIN_BATCH * 1e3 / median_ms,
              "val_ms": timings["val_ms"], "diffusion_loss": losses, "best_val_loss": best_val,
              "scale_factor": timings["scale_factor"], "peak_device_memory_gib": peak_gib}
    emit({"phase": "train_main_path" if amp else "train_fp32_main_path",
          "config": "config_train_32g.json", "patch": [80, 80, 80], "batch": TRAIN_BATCH,
          "dtype": dtype, "setup_s": round(setup_s, 3), "run_s": round(run_s, 3), **record,
          "allow_tf32": flags, "card": card, "nvidia_smi": smi_line})
    phase_train_profile(torch, ns, model_dir, timings["scale_factor"], getattr(torch, dtype))
    shutil.rmtree(model_dir)
    return {**record, "gn_cases": gn_cases}


def phase_train_profile(torch, ns, model_dir: Path, scale_factor: float, dt) -> None:
    """One flagship train step (batch 20, in ``dt``) under torch.profiler,
    after a warm-up step, built from the library's pieces and the run's VAE."""
    from ldm3d_torch.cli.train_diffusion import load_frozen_autoencoder
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage2Config, TrainState, make_diffusion_optimizer,
                                      make_stage2_train_step)

    args = SimpleNamespace(**vars(ns), model_dir=str(model_dir))
    ae = load_frozen_autoencoder(args, torch.device("cuda"), dt)
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.device("cuda"):
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    unet.compute_dtype = dt
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda count: 1e-5))
    step = make_stage2_train_step(unet, ae, DDPMScheduler.create(), Stage2Config())
    batch = {k: torch.rand((TRAIN_BATCH, 80, 80, 80, 1), generator=gen, device="cuda")
             for k in ("image", "label")}
    step(state, batch, scale_factor, gen)
    torch.cuda.synchronize()

    def one_step():
        t0 = time.perf_counter()
        step(state, batch, scale_factor, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prof, window_ms = _profiled(torch, one_step)
    dtype = str(dt).removeprefix("torch.")
    emit({"phase": "profile", "path": f"training step (batch 20, 80^3, {dtype})",
          **_profile_summary(torch, prof, window_ms)})
    del state, unet, ae, batch
    torch.cuda.empty_cache()

def phase_train_ae(torch, ns, counts, workdir: Path, card: str, smi_line: str,
                   amp: bool = True) -> dict:
    """Full-width stage-1 training through ``cli.train_autoencoder``: the
    ``config_train_32g.json`` VAE, the CLI's discriminator and LPIPS at
    batch 1 on 64^3 crops of synthetic 80^3 pairs, 2 epochs (a warm-up
    epoch, then an adversarial one), each validated; in bf16 with ``--amp``
    or in fp32 without it. Returns its record."""
    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.cli.train_autoencoder import main as train_ae_main
    from ldm3d_torch.cli.train_diffusion import load_frozen_autoencoder
    from ldm3d_torch.configs import load_json, preset_path

    t0 = time.perf_counter()
    dtype = "bfloat16" if amp else "float32"
    model_dir = workdir / f"train_ae_{dtype}"
    model_dir.mkdir(parents=True)
    cfg = load_json(preset_path("config_train_32g.json"))
    check(tuple(cfg["autoencoder_train"]["patch_size"]) == AE_PATCH
          and cfg["autoencoder_train"]["batch_size"] == 1,
          f"the preset's stage-1 patch is not batch 1 at {AE_PATCH}")
    cfg["autoencoder_train"].update(warmup_epochs=0, val_interval=1, max_epochs=2)
    cfg_path = model_dir / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    env = _write_env(model_dir, synthetic_num=AE_PAIRS, synthetic_shape=list(AE_VOLUME),
                     resume_ckpt=False)
    setup_s = time.perf_counter() - t0

    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    unpin_precision(torch)
    t_run = time.perf_counter()
    best_val = train_ae_main(["-c", str(cfg_path), "-e", str(env), *(["--amp"] if amp else []),
                              "--no-images"], timings=timings)
    run_s = time.perf_counter() - t_run
    launches, gn_cases = _read_counts(), _read_gn_cases()
    flags = pinned_precision(torch, "cli.train_autoencoder.main")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    adv = timings["adv_active"]
    warm, steps_adv = adv.count(False), adv.count(True)
    steps, val_batches = len(adv), sum(timings["val_batches"])
    check(warm == steps_adv == AE_PAIRS and val_batches == 2,
          f"expected {AE_PAIRS} warm-up and {AE_PAIRS} adversarial steps and 2 validation "
          f"batches, got {warm}, {steps_adv}, {val_batches}")
    losses = {k: timings[k] for k in ("g_loss", "d_loss", "recon_loss", "kl_loss",
                                      "perceptual_loss", "adv_loss", "g_grad_norm")}
    check(all(math.isfinite(x) for v in losses.values() for x in v) and math.isfinite(best_val),
          f"non-finite stage-1 losses: {losses}, val {best_val}")
    check(min(losses["d_loss"][warm:]) > 0 and max(losses["d_loss"][:warm]) == 0,
          f"the discriminator's loss is not 0 in warm-up and > 0 after it: {losses['d_loss']}")
    # exact launches: the VAE's 4 attentions (d = 256) a forward, backward
    # in every step; its GroupNorms and, in an adversarial step, the
    # discriminator's instance norms in D(recon) for G and D(recon), D(real)
    # for D, forward and backward
    attn = counts["encoder"]["attn"] + counts["decoder"]["attn"]
    vae_gn = counts["encoder"]["gn"] + counts["decoder"]["gn"]
    d_gn = counts["discriminator"]["gn"]
    fwd_route, bwd_route = ("wgmma", "mma") if amp else ("fp32", "fp32")
    expected = {
        "flash_fwd": attn * (steps + val_batches),
        f"flash_fwd_{fwd_route}": attn * (steps + val_batches),
        "flash_bwd_dq": attn * steps, "flash_bwd_dkv": attn * steps,
        f"flash_bwd_dq_{bwd_route}": attn * steps, f"flash_bwd_dkv_{bwd_route}": attn * steps,
        "gn_sums": vae_gn * (steps + val_batches) + 3 * d_gn * steps_adv,
        "gn_bwd_sums": vae_gn * steps + 3 * d_gn * steps_adv,
        "conv3d_igemm": 0,
    }
    for name, n in expected.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times in stage-1 "
                                   f"training ({dtype}), expected {n}")
    per_step = {"warmup": {"flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
                           "gn_sums": vae_gn, "gn_bwd_sums": vae_gn},
                "adversarial": {"flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
                                "gn_sums": vae_gn + 3 * d_gn, "gn_bwd_sums": vae_gn + 3 * d_gn},
                "validation_batch": {"flash_fwd": attn, "gn_sums": vae_gn}}

    # the checkpoints: stage 2 loads the autoencoder's best; last resumes both
    args = SimpleNamespace(**cfg, model_dir=str(model_dir))
    ae = load_frozen_autoencoder(args, torch.device("cuda"), getattr(torch, dtype))
    check(all(bool(torch.isfinite(p).all()) for p in ae.parameters()),
          "the stage-1 autoencoder_best.pt holds non-finite params")
    n_params = sum(p.numel() for p in ae.parameters())
    del ae
    last = CheckpointManager(str(model_dir), "autoencoder").load("last", map_location="cpu")
    check(last["g"]["step"] == steps and last["d"]["step"] == steps_adv
          and last["meta"]["epoch"] == 1, f"stage-1 last at G step {last['g']['step']}, "
                                          f"D step {last['d']['step']}")
    check(CheckpointManager(str(model_dir), "discriminator").exists("best"),
          "discriminator_best.pt not written")
    del last

    step_ms = timings["train_step_ms"]
    med_warm = statistics.median(step_ms[1:warm])
    med_adv = statistics.median(step_ms[warm + 1:])
    record = {"steps": steps, "warmup_steps": warm, "adversarial_steps": steps_adv,
              "val_batches": val_batches, "launches": launches, "expected_launches": expected,
              "launches_per_step": per_step, "train_step_ms": step_ms,
              "median_warmup_step_ms": med_warm, "median_adversarial_step_ms": med_adv,
              "volumes_per_s_trained": 1e3 / med_adv, "val_ms": timings["val_ms"],
              "losses": losses, "val_loss": timings["val_loss"], "best_val_loss": best_val,
              "peak_device_memory_gib": peak_gib}
    emit({"phase": "train_ae_main_path" if amp else "train_ae_fp32_main_path",
          "config": "config_train_32g.json", "patch": list(AE_PATCH),
          "volume": list(AE_VOLUME), "batch": 1, "dtype": dtype,
          "autoencoder_params": n_params, "setup_s": round(setup_s, 3),
          "run_s": round(run_s, 3), **record, "allow_tf32": flags, "card": card,
          "nvidia_smi": smi_line})
    record["profile"] = phase_train_ae_profile(torch, ns, getattr(torch, dtype), med_adv)
    shutil.rmtree(model_dir)
    return {**record, "gn_cases": gn_cases}


def phase_train_ae_profile(torch, ns, dt, step_ms: float) -> dict:
    """One adversarial stage-1 step (G and D, batch 1, 64^3, in ``dt``)
    under torch.profiler with the ops' input shapes (which file LPIPS's 2D
    convolutions apart), after a warm-up step, built from the library's
    pieces with the CLI's models. Besides the idle share of the profiled
    window (which holds the profiler's own host cost), the idle share of
    ``step_ms``, the unprofiled step's median."""
    from ldm3d_torch.cli.train_autoencoder import build_discriminator, build_lpips
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage1Config, TrainState, make_optimizer,
                                      make_stage1_train_step)

    gen = torch.Generator(device="cuda").manual_seed(8)
    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        disc = init_weights_(build_discriminator(ns), gen)
    ae.compute_dtype = disc.compute_dtype = dt
    lpips = build_lpips(SimpleNamespace(), dt, torch.device("cuda"))
    g_state = TrainState(ae, make_optimizer(ae.parameters(), lambda count: 1e-5))
    d_state = TrainState(disc, make_optimizer(disc.parameters(), lambda count: 1e-5))
    step = make_stage1_train_step(ae, disc, lpips, Stage1Config(
        kl_weight=ns.autoencoder_train["kl_weight"],
        perceptual_weight=ns.autoencoder_train["perceptual_weight"]))
    images = torch.rand((1, *AE_PATCH, 1), generator=gen, device="cuda")
    step(g_state, d_state, images, True, gen)
    torch.cuda.synchronize()

    def one_step():
        t0 = time.perf_counter()
        step(g_state, d_state, images, True, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    from ldm3d_torch.ops import groupnorm as G

    before = G.gn_bwd_sums.launches
    prof, window_ms = _profiled(torch, one_step, record_shapes=True)
    calls = G.gn_bwd_sums.launches - before
    dtype = str(dt).removeprefix("torch.")
    # B5 is one kernel a call: as many gn_bwd_sums_onepass kernels as calls,
    # none of the split pass and combine pass it replaced
    b5 = _device_kernel_count(torch, prof, ("gn_bwd_sums_onepass",))
    replaced = _device_kernel_count(torch, prof, ("partial_sums", "combine("))
    check(calls > 0 and b5 == calls and replaced == 0,
          f"profiled stage-1 step: {b5} gn_bwd_sums_onepass kernels for {calls} gn_bwd_sums "
          f"calls, {replaced} partial_sums/combine kernels")
    summary = _profile_summary(torch, prof, window_ms)
    summary["gn_bwd_sums_calls"], summary["gn_bwd_sums_kernels"] = calls, b5
    summary["unprofiled_step_ms"] = step_ms
    summary["device_idle_share_of_unprofiled_step"] = 1.0 - summary["device_busy_ms"] / step_ms
    emit({"phase": "profile", "path": f"stage-1 adversarial step (batch 1, 64^3, {dtype})",
          **summary})
    del g_state, d_state, ae, disc, lpips, images
    torch.cuda.empty_cache()
    return summary


def _post(port: int, body: dict) -> tuple[int, dict, float]:
    """POST /generate on the local server; (status, JSON reply, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data), time.perf_counter() - t0


def _get(port: int, path: str) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _served_volume(reply: dict, tmp: Path) -> np.ndarray:
    """The reply's one volume, decoded from raw float32 or NIfTI."""
    import base64

    from ldm3d_torch.utils.nifti import read_nifti

    sample = reply["samples"][0]
    raw = base64.b64decode(sample["data"])
    if sample["format"] == "nii":
        path = tmp / "served.nii"
        path.write_bytes(raw)
        return read_nifti(str(path))[0]
    return np.frombuffer(raw, np.float32).reshape(sample["shape"])


def phase_serve(torch, ns, counts, workdir: Path, card: str, smi_line: str) -> dict:
    """The serving main path over HTTP; returns its launch counts and the
    GroupNorm wrappers' inputs."""
    import base64
    import threading

    from ldm3d_torch.cli.common import save_two_stage
    from ldm3d_torch.configs import preset_path
    from ldm3d_torch.serving.api_server import Api, make_stdlib_server
    from ldm3d_torch.serving.model_server import ModelServer

    model_dir = workdir / "serve"
    ae, unet = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(8))
    save_two_stage(str(model_dir), ae, unet, scale_factor=0.8)
    del ae, unet
    torch.cuda.empty_cache()
    env = _write_env(model_dir)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ModelServer(preset_path("config_train_32g.json"), str(env), sampler="ddim",
                         steps=SERVE_STEPS, batch=SERVE_BATCH, decode_chunk=0, device="cuda")
    unpin_precision(torch)
    server.load_model()
    load_s = time.perf_counter() - t0
    pinned_precision(torch, "ModelServer.load_model")
    check(server.is_dummy is False and server.model_loaded, "the server loaded the dummy model")
    # widen the micro-batch window from 10 ms to 1.5 s, so that the merge of
    # the concurrent pair does not hang on the second request's condition
    # encode and HTTP parsing (each alone request then waits out the window)
    server._batcher.max_wait = 1.5
    httpd = make_stdlib_server(Api(server), "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    patch = list(server.patch_size)

    def cond(seed):
        vol = np.random.default_rng(seed).random(patch, dtype=np.float32)
        return {"data": base64.b64encode(vol.tobytes()).decode("ascii"), "shape": patch}

    cond_a, cond_b = cond(1), cond(2)
    try:
        code, _, warm_s = _post(port, {"num_samples": 1, "seed": 0, "condition": cond_a})
        check(code == 200, f"warm-up request returned {code}")
        _reset_counts()
        batches_before = server._batcher.batches_run
        replies, seconds = {}, {}

        def client(name, body):
            code, reply, sec = _post(port, body)
            replies[name], seconds[name] = (code, reply), sec

        pair = [threading.Thread(target=client, args=(name, {"num_samples": 1, "seed": seed,
                                                             "condition": c}))
                for name, seed, c in (("a_batched", 11, cond_a), ("b_batched", 22, cond_b))]
        for t in pair:
            t.start()
        for t in pair:
            t.join()
        merged_calls = server._batcher.batches_run - batches_before
        for name, body in (
                ("a_alone", {"num_samples": 1, "seed": 11, "condition": cond_a}),
                ("a_alone_repeat", {"num_samples": 1, "seed": 11, "condition": cond_a}),
                ("dpm", {"num_samples": 1, "seed": 5, "condition": cond_a, "sampler": "dpm",
                         "inference_steps": SERVE_DPM_STEPS}),
                ("nii", {"num_samples": 1, "seed": 7, "condition": cond_a,
                         "output_format": "nii"})):
            client(name, body)
        torch.cuda.synchronize()
        launches, gn_cases = _read_counts(), _read_gn_cases()
        flags = pinned_precision(torch, "the served requests")
        # the device profile of one served call, a request alone (it waits
        # out the batching window, which the profiled window holds)
        prof, (code, _, prof_s) = _profiled(torch, lambda: _post(
            port, {"num_samples": 1, "seed": 3, "condition": cond_b, "sampler": "ddim",
                   "inference_steps": SERVE_PROFILE_STEPS}))
        check(code == 200, f"the profiled request returned {code}")
        emit({"phase": "profile", "path": f"serving request (fp32, ddim-{SERVE_PROFILE_STEPS}, batch "
                                          f"{SERVE_BATCH} call, over HTTP)",
              "request_s": prof_s, "batch_window_s": server._batcher.max_wait,
              **_profile_summary(torch, prof, prof_s * 1e3)})
        del prof
        health = _get(port, "/health")
        metrics = _get(port, "/metrics")
        info = _get(port, "/model/info")
    finally:
        httpd.shutdown()
        httpd.server_close()
        if server._batcher is not None:
            server._batcher.close()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    vols = {}
    for name, (code, reply) in replies.items():
        check(code == 200, f"serve request {name} returned {code}: {reply}")
        want = ("dpm", SERVE_DPM_STEPS) if name == "dpm" else ("ddim", SERVE_STEPS)
        check((reply["sampler"], reply["inference_steps"]) == want,
              f"{name}: served {reply['sampler']}-{reply['inference_steps']}, expected {want}")
        check(reply["timestep_spacing"] == "leading" and reply["conditioning"] == "provided",
              f"{name}: spacing {reply['timestep_spacing']}, conditioning "
              f"{reply['conditioning']}")
        vols[name] = _served_volume(reply, workdir)
        check(vols[name].shape == (80, 80, 80) and bool(np.isfinite(vols[name]).all()),
              f"{name}: volume {vols[name].shape}, finite {np.isfinite(vols[name]).all()}")
    check(merged_calls == 1, f"the two concurrent requests took {merged_calls} sampler calls, "
                             f"not one merged batch-{SERVE_BATCH} call")
    batched_vs_alone = float(np.abs(vols["a_batched"] - vols["a_alone"]).max())
    same_seed = float(np.abs(vols["a_alone"] - vols["a_alone_repeat"]).max())
    check(batched_vs_alone <= SERVE_TOL, f"batched and alone differ by {batched_vs_alone}")
    check(same_seed <= SERVE_TOL, f"a same-seed repeat differs by {same_seed}")
    check(float(np.abs(vols["a_batched"] - vols["b_batched"]).max()) > 0.01,
          "two seeds served the same volume")
    check(health[0] == 200 and json.loads(health[1])["dummy_model"] is False,
          f"/health: {health}")
    check(metrics[0] == 200 and b'api_requests_total{method="POST",endpoint="/generate",'
                                b'status="200"}' in metrics[1], "/metrics lacks the requests")
    check(info[0] == 200 and json.loads(info[1])["backend"] == "cuda", f"/model/info: {info}")

    # launches: every request encodes its condition; four ddim-50 calls (the
    # merged pair, alone twice, the NIfTI one) and one dpm-20 call, each
    # followed by one batch-2 decode
    encodes, decodes = 6, 5
    unet_calls = 4 * SERVE_STEPS + SERVE_DPM_STEPS
    expected = {key: encodes * counts["encoder"][k] + unet_calls * counts["unet"][k]
                + decodes * counts["decoder"][k]
                for key, k in (("flash_fwd", "attn"), ("gn_sums", "gn"))}
    for name, n in expected.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times serving, expected {n}")
    check(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == launches["gn_bwd_sums"]
          == launches["conv3d_igemm"] == launches["flash_fwd_wgmma"] == 0,
          f"an unexpected kernel ran serving: {launches}")
    emit({"phase": "serve", "config": "config_train_32g.json", "volume": [80, 80, 80],
          "dtype": "float32", "batch": SERVE_BATCH, "sampler": f"ddim-{SERVE_STEPS}",
          "load_s": load_s, "warmup_request_s": warm_s, "request_s": seconds,
          "merged_sampler_calls": merged_calls, "launches": launches,
          "expected_launches": expected, "batched_vs_alone_max_abs": batched_vs_alone,
          "same_seed_max_abs": same_seed, "tol": SERVE_TOL,
          "peak_device_memory_gib": peak_gib, "allow_tf32": flags, "card": card,
          "nvidia_smi": smi_line})
    del server
    torch.cuda.empty_cache()
    shutil.rmtree(model_dir)
    return {"launches": launches, "gn_cases": gn_cases}


def phase_kernel_conv(torch) -> dict:
    """B6 through its entry point, the A/B tool, at its shapes in bf16 and
    fp32; returns the records and the tool run's launches."""
    from ldm3d_torch.ops.conv3d import conv3d_igemm
    from ldm3d_torch.tools import conv_ab

    for x_shape, w_shape, msg in (((1, 2, 4, 8, 8), (5, 5, 5, 8, 8), "3x3x3"),
                                  ((1, 2, 4, 8, 128), (3, 3, 3, 128, 128), "C <= 64"),
                                  ((1, 2, 4, 12, 8), (3, 3, 3, 8, 8), "W % 8")):
        try:
            conv3d_igemm(torch.zeros(x_shape, device="cuda"), torch.zeros(w_shape, device="cuda"))
        except ValueError as e:
            check(msg in str(e), f"conv3d_igemm raised {e!r} for {x_shape}, {w_shape}")
        else:
            check(False, f"conv3d_igemm took the untargeted shape {x_shape}, {w_shape}")
    from ldm3d_torch.ops._kernels import conv3d_library
    from ldm3d_torch.ops.conv3d import conv3d_plan

    for shape in conv_ab.SHAPES:  # the CUDA library's launch plan is conv3d_plan's
        for dtype in conv_ab.DTYPES:
            out = (ctypes.c_int64 * 6)()
            check(conv3d_library().ldm3d_conv3d_plan(int(dtype == "bfloat16"), *shape, shape[4],
                                                     out) == 0, f"conv plan refused {shape}")
            py = conv3d_plan(shape, shape[4], getattr(torch, dtype))
            want = [py["tile_w"], py["tile_h"], *py["grid"], py["threads"], py["smem_bytes"]]
            check(list(out) == want, f"conv plan at {shape} {dtype}: CUDA {list(out)}, "
                                     f"Python {want}")

    def emit_rec(rec):
        key = (tuple(rec["shape"]), rec["dtype"])
        if key in EARLIER_CONV_MS:
            rec["recorded_earlier_ms"] = EARLIER_CONV_MS[key]
        emit({"phase": "kernel_conv", "route": CONV_ROUTES[rec["dtype"]], **rec})

    _reset_counts()
    t0 = time.perf_counter()
    recs = conv_ab.run(emit=emit_rec)
    launches = _read_counts()
    check(launches["conv3d_igemm"] > 0, "the conv path launched no conv kernel")
    emit({"phase": "kernel_conv_path", "launches": launches["conv3d_igemm"],
          "seconds": time.perf_counter() - t0, "cases": len(recs)})
    return {"records": recs, "launches": launches["conv3d_igemm"]}


@full_fp32
def phase_card_vs_cpu(torch) -> None:
    """The tiny preset's whole sample on the card (kernels) and on the CPU
    (plain), same weights, noise and condition, fp32 with TF32 off."""
    import copy

    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.diffusion import DDIMScheduler, inferer
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.ops.attention import flash_attention_fwd

    cfg = load_json(preset_path("config_tiny_cpu.json"))
    ns = SimpleNamespace(**cfg)
    gen = torch.Generator().manual_seed(2)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval()
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen).eval()
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    batch, patch = 2, cfg["diffusion_train"]["patch_size"]
    latent = (batch, *[p // ae.downsample_factor for p in patch], cfg["latent_channels"])
    images = torch.rand((batch, *patch, 1), generator=gen)
    eps, noise = torch.randn(latent, generator=gen), torch.randn(latent, generator=gen)
    sched = DDIMScheduler.create(num_train_timesteps=16, beta_start=0.0015, beta_end=0.0195,
                                 num_inference_steps=8)
    for guidance in (1.0, 2.0):
        outs = {}
        for device in ("cuda", "cpu"):
            a = copy.deepcopy(ae).to(device)
            u = copy.deepcopy(unet).to(device)
            before = flash_attention_fwd.launches
            with torch.no_grad():
                cond = a.encode_stage_2_inputs(images.to(device), eps.to(device))
                vol = inferer.sample(u, a.decode_stage_2_outputs, sched, noise.to(device),
                                     condition=cond, scale_factor=0.8, guidance_scale=guidance)
            outs[device] = (vol.cpu(), flash_attention_fwd.launches - before)
        diff = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
        check(outs["cuda"][1] > 0 and outs["cpu"][1] == 0,
              f"kernel launches card/cpu = {outs['cuda'][1]}/{outs['cpu'][1]}")
        check(math.isfinite(diff) and diff <= 1e-3, f"card and CPU samples differ by {diff}")
        emit({"phase": "card_vs_cpu", "config": "config_tiny_cpu.json", "batch": batch,
              "guidance": guidance, "steps": 8, "max_abs_diff": diff, "tol": 1e-3,
              "card_kernel_launches": outs["cuda"][1]})


@full_fp32
def phase_train_card_vs_cpu(torch) -> None:
    """One ``config_tiny_cpu.json`` train step (full step, VAE encode inside)
    on the card (kernels) and on the CPU (plain): same weights, batch and
    draws, fp32 with TF32 off; loss, per-leaf gradients and updated
    parameters compared."""
    import copy

    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage2Config, Stage2Draws, TrainState,
                                      make_diffusion_optimizer, make_stage2_train_step)

    cfg = load_json(preset_path("config_tiny_cpu.json"))
    ns = SimpleNamespace(**cfg)
    gen = torch.Generator().manual_seed(7)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval().requires_grad_(False)
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    b, patch = 2, cfg["diffusion_train"]["patch_size"]
    latent = (b, *[p // ae.downsample_factor for p in patch], cfg["latent_channels"])
    batch = {k: torch.rand((b, *patch, 1), generator=gen) for k in ("image", "label")}
    draws = Stage2Draws(torch.randn(latent, generator=gen), torch.randn(latent, generator=gen),
                        torch.randn(latent, generator=gen), torch.tensor([3, 12]),
                        torch.tensor([True, False]))
    s2cfg = Stage2Config(cond_dropout=0.5)
    sched = DDPMScheduler.create(num_train_timesteps=16)
    out = {}
    for device in ("cuda", "cpu"):
        _reset_counts()
        u = copy.deepcopy(unet).to(device)
        a = copy.deepcopy(ae).to(device)
        state = TrainState(u, make_diffusion_optimizer(u.parameters(), lambda count: TINY_LR))
        step = make_stage2_train_step(u, a, sched, s2cfg)
        m = step(state, {k: v.to(device) for k, v in batch.items()}, 0.9, draws=draws.to(device))
        out[device] = {"loss": float(m["diffusion_loss"]), "grad_norm": float(m["grad_norm"]),
                       "grads": {n: p.grad.cpu() for n, p in u.named_parameters()},
                       "params": {n: p.detach().cpu() for n, p in u.named_parameters()},
                       "launches": _read_counts()}
    card, cpu = out["cuda"], out["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_worst = max((card["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                     for n, g in cpu["grads"].items())
    param_worst = max((card["params"][n] - p).abs().max().item()
                      for n, p in cpu["params"].items())
    check(loss_rel <= TRAIN_LOSS_REL, f"card and CPU train-step losses differ by {loss_rel} rel")
    check(grad_worst <= TRAIN_GRAD_REL, f"card and CPU gradients differ by {grad_worst} of "
                                        f"a leaf's largest |g|")
    check(param_worst <= 2 * TINY_LR + 1e-6, f"card and CPU updated params differ by "
                                              f"{param_worst}")
    norm_rel = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    check(norm_rel <= TRAIN_GRAD_REL, f"card and CPU gradient norms differ by {norm_rel} rel")
    launched = card["launches"]
    check(all(launched[k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gn_sums",
                                         "gn_bwd_sums")),
          f"a kernel did not run in the card's train step: {launched}")
    check(all(cpu["launches"][k] == 0 for k in ("flash_fwd", "gn_sums")),
          "the CPU step launched a kernel")
    emit({"phase": "train_card_vs_cpu", "config": "config_tiny_cpu.json", "batch": b,
          "loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel_diff": loss_rel,
          "grad_norm_card": card["grad_norm"], "grad_norm_cpu": cpu["grad_norm"],
          "grad_worst_rel_to_leaf_max": grad_worst, "param_max_abs_diff": param_worst,
          "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel": TRAIN_GRAD_REL,
                  "param_abs": 2 * TINY_LR + 1e-6},
          "card_launches": launched})


@full_fp32
def phase_stage1_card_vs_cpu(torch) -> None:
    """One ``config_tiny_cpu.json`` adversarial stage-1 step (G, then D) on
    the card (kernels) and on the CPU (plain): the same weights (the CLI's
    discriminator, LPIPS's fixed init), batch and draws, fp32 with TF32 off;
    every metric within STAGE1_REL relative; the gradients each update
    applied (G's from the generator loss, D's from the discriminator loss,
    each after the global-norm clip, a positive scale) within TRAIN_GRAD_REL
    of the model's largest |g|, so the backward of the discriminator's
    instance norms (B5) is held too (the bound is the model's, as
    ``tests/test_torch_discriminator.py`` holds D: a conv bias before an
    instance norm has a gradient of rounding noise only); both models'
    params after the updates within 2 lr + 1e-6."""
    import copy

    from ldm3d_torch.cli.train_autoencoder import build_discriminator
    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.nn import LPIPS, init_lpips_, init_weights_
    from ldm3d_torch.training import (Stage1Config, Stage1Draws, TrainState, make_optimizer,
                                      make_stage1_train_step)

    cfg = load_json(preset_path("config_tiny_cpu.json"))
    ns = SimpleNamespace(**cfg)
    gen = torch.Generator().manual_seed(12)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
    disc = init_weights_(build_discriminator(ns), gen)
    lpips = init_lpips_(LPIPS()).requires_grad_(False)
    b, patch = 2, cfg["autoencoder_train"]["patch_size"]
    latent = (b, *[p // ae.downsample_factor for p in patch], cfg["latent_channels"])
    images = torch.rand((b, *patch, 1), generator=gen) * 1.2 - 0.1
    draws = Stage1Draws(torch.randn(latent, generator=gen),
                        tuple(torch.randperm(n, generator=gen)[:math.ceil(0.2 * n)]
                              for n in patch))
    s1cfg = Stage1Config(kl_weight=cfg["autoencoder_train"]["kl_weight"], perceptual_weight=0.1)
    out = {}
    for device in ("cuda", "cpu"):
        _reset_counts()
        a, d, lp = (copy.deepcopy(m).to(device) for m in (ae, disc, lpips))
        g_state = TrainState(a, make_optimizer(a.parameters(), lambda count: TINY_LR))
        d_state = TrainState(d, make_optimizer(d.parameters(), lambda count: TINY_LR))
        m = make_stage1_train_step(a, d, lp, s1cfg)(g_state, d_state, images.to(device), True,
                                                    draws=draws.to(device))
        leaves = [(f"{name}.{n}", p) for name, model in (("g", a), ("d", d))
                  for n, p in model.named_parameters()]
        out[device] = {"metrics": {k: float(v) for k, v in m.items()},
                       "grads": {n: p.grad.cpu() for n, p in leaves},
                       "params": {n: p.detach().cpu() for n, p in leaves},
                       "launches": _read_counts()}
    card, cpu = out["cuda"], out["cpu"]
    rel = {k: abs(card["metrics"][k] - v) / max(abs(v), 1e-30)
           for k, v in cpu["metrics"].items()}
    largest = {model: max(g.abs().max().item() for n, g in cpu["grads"].items()
                          if n.startswith(model + ".")) for model in ("g", "d")}
    grad_rel = {n: (card["grads"][n] - g).abs().max().item() / max(largest[n[0]], 1e-30)
                for n, g in cpu["grads"].items()}
    grad_leaf = max(grad_rel, key=grad_rel.get)
    param_worst = max((card["params"][n] - p).abs().max().item()
                      for n, p in cpu["params"].items())
    check(max(rel.values()) <= STAGE1_REL, f"card and CPU stage-1 metrics differ: {rel}")
    check(grad_rel[grad_leaf] <= TRAIN_GRAD_REL,
          f"card and CPU stage-1 gradients of {grad_leaf} differ by {grad_rel[grad_leaf]} of "
          f"the model's largest |g|")
    check(param_worst <= 2 * TINY_LR + 1e-6, f"card and CPU stage-1 params differ by "
                                              f"{param_worst}")
    launched = card["launches"]
    check(all(launched[k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gn_sums",
                                         "gn_bwd_sums")),
          f"a kernel did not run in the card's stage-1 step: {launched}")
    check(all(cpu["launches"][k] == 0 for k in ("flash_fwd", "gn_sums", "gn_bwd_sums")),
          "the CPU stage-1 step launched a kernel")
    emit({"phase": "stage1_card_vs_cpu", "config": "config_tiny_cpu.json", "batch": b,
          "metrics_card": card["metrics"], "metrics_cpu": cpu["metrics"],
          "metric_rel_diff": rel,
          "grad_worst_rel_to_model_max": {
              model: max(v for n, v in grad_rel.items() if n.startswith(model + "."))
              for model in ("g", "d")},
          "grad_worst_leaf": grad_leaf, "param_max_abs_diff": param_worst,
          "tol": {"metric_rel": STAGE1_REL, "grad_rel": TRAIN_GRAD_REL,
                  "param_abs": 2 * TINY_LR + 1e-6},
          "card_launches": launched})


# distillation runs of the distill phase: (argv of cli.distill, steps a run)
DISTILL_RUNS = {
    "a_bf16_v": (["--amp", "--teacher-steps", "8", "--rounds", "2", "--steps-per-round", "4",
                  "--student-prediction", "v_prediction"], 8),
    "b_fp32_guided": (["--teacher-steps", "4", "--rounds", "1", "--steps-per-round", "2",
                       "--guidance-distill", "2.0"], 2),
}
EVAL_PAIRS = 2
# card against CPU: SSIM and MS-SSIM (in [0, 1]) within EVAL_TOL; the
# full-width encoder's fp32 latent features within FEATURES_REL of their
# largest |value| (its convolutions, K up to 27 * 256 terms, summed in other
# orders on the card and the CPU)
EVAL_TOL = 1e-5
FEATURES_REL = 1e-4


def _distill_per_step(counts, amp: bool) -> dict:
    """One distillation step's launches: two encodes, two teacher UNet
    forwards (batched CFG is one call) and the student's forward and
    backward."""
    enc, unet = counts["encoder"], counts["unet"]
    return {"flash_fwd": 2 * enc["attn"] + 3 * unet["attn"],
            "flash_fwd_wgmma": 2 * enc["attn"] if amp else 0,
            "flash_bwd_dq": unet["attn"], "flash_bwd_dkv": unet["attn"],
            "flash_bwd_dq_wgmma": unet["attn"] if amp else 0,
            "flash_bwd_dkv_wgmma": unet["attn"] if amp else 0,
            "gn_sums": 2 * enc["gn"] + 3 * unet["gn"], "gn_bwd_sums": unet["gn"],
            "conv3d_igemm": 0}


def phase_distill(torch, ns, counts, workdir: Path, card: str, smi_line: str,
                  stage2_per_step: dict | None = None) -> dict:
    """Full-width progressive distillation through ``cli.distill`` (batch 20,
    80^3, the seeded flagship checkpoints) in each of DISTILL_RUNS: finite
    losses, the exact launches a step by kernel and route (held to a
    stage-2 step's when given: the same backward, two more UNet forwards), no
    teacher gradient, the distilled checkpoint and its meta. After run a, its
    2-step student samples through ``cli.inference --use-distilled`` eagerly
    and with ``--fused-decode`` (equal bit for bit) and through an in-process
    ``ModelServer(sampler="distilled")``, which answers one request and
    refuses one with guidance. Returns the record, with the model directory
    (its distilled role from run b) for the evaluate phase."""
    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.cli.distill import main as distill_main
    from ldm3d_torch.configs import preset_path

    t0 = time.perf_counter()
    model_dir, _ = _flagship_checkpoints(torch, ns, workdir)
    env = _write_env(model_dir, synthetic_num=TRAIN_PAIRS, resume_ckpt=False)
    cfg_path = preset_path("config_train_32g.json")
    setup_s = time.perf_counter() - t0
    record: dict = {"model_dir": model_dir, "runs": {}}
    for name, (extra, steps) in DISTILL_RUNS.items():
        amp = "--amp" in extra
        gc.collect()
        torch.cuda.empty_cache()
        timings: dict = {}
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        unpin_precision(torch)
        t_run = time.perf_counter()
        final = distill_main(["-c", cfg_path, "-e", str(env), *extra], timings=timings)
        run_s = time.perf_counter() - t_run
        launches, gn_cases = _read_counts(), _read_gn_cases()
        flags = pinned_precision(torch, "cli.distill.main")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = [x for r in timings["distill_loss"] for x in r]
        check(len(losses) == steps, f"{name}: {len(losses)} distillation steps, expected {steps}")
        check(all(math.isfinite(x) for x in losses) and math.isfinite(final),
              f"{name}: non-finite distillation losses {losses}")
        check(timings["teacher_params_with_grad"] == [0] * len(timings["step_ms"]),
              f"{name}: teacher parameters hold gradients: {timings['teacher_params_with_grad']}")
        per_step = _distill_per_step(counts, amp)
        for key, n in per_step.items():
            check(launches[key] == steps * n, f"{name}: {key} launched {launches[key]} times, "
                                              f"expected {steps} steps of {n}")
        if stage2_per_step is not None and amp:
            # a stage-2 step's backward, and two more UNet forwards
            unet = counts["unet"]
            for key in ("flash_bwd_dq", "flash_bwd_dkv", "gn_bwd_sums", "flash_fwd_wgmma"):
                check(per_step[key] == stage2_per_step[key], f"{key}: a distillation step's "
                      f"{per_step[key]} against a stage-2 step's {stage2_per_step[key]}")
            check(per_step["flash_fwd"] == stage2_per_step["flash_fwd"] + 2 * unet["attn"]
                  and per_step["gn_sums"] == stage2_per_step["gn_sums"] + 2 * unet["gn"],
                  f"a distillation step's forwards {per_step} against a stage-2 step's "
                  f"{stage2_per_step}")
        meta = CheckpointManager(str(model_dir), "diffusion").load_meta("distilled")
        rounds = int(extra[extra.index("--rounds") + 1])
        final_steps = int(extra[extra.index("--teacher-steps") + 1]) >> rounds
        check(meta["num_steps"] == final_steps and len(meta["timesteps"]) == final_steps
              and meta["final_loss"] == final, f"{name}: distilled meta {meta}")
        step_ms = [ms for r in timings["step_ms"] for ms in r[1:]]  # each round's first warms
        median_ms = statistics.median(step_ms)
        run = {"steps": steps, "launches": launches, "launches_per_step": per_step,
               "step_ms": timings["step_ms"], "median_step_ms_after_warmup": median_ms,
               "volumes_per_s_distilled": TRAIN_BATCH * 1e3 / median_ms,
               "distill_loss": timings["distill_loss"], "grad_norm": timings["grad_norm"],
               "final_loss": final, "peak_device_memory_gib": peak_gib, "meta": meta}
        emit({"phase": "distill", "run": name, "config": "config_train_32g.json",
              "patch": [80, 80, 80], "batch": TRAIN_BATCH,
              "dtype": "bfloat16" if amp else "float32", "argv": extra,
              "setup_s": round(setup_s, 3), "run_s": round(run_s, 3), **run,
              "step_ms_note": "device ms a step from CUDA events around each step, read after "
                              "the round; the median leaves each round's first step out",
              "allow_tf32": flags, "card": card, "nvidia_smi": smi_line})
        record["runs"][name] = {**run, "gn_cases": gn_cases}
        if name == "a_bf16_v":
            _distilled_sample_and_serve(torch, counts, model_dir, env, cfg_path, final_steps,
                                        card, smi_line)
    return record


def _distilled_sample_and_serve(torch, counts, model_dir, env, cfg_path, n_steps, card,
                                smi_line) -> None:
    """The distilled student through ``cli.inference --use-distilled``, eager
    and fused (bit-equal; the launches its n_steps UNet calls and the VAE
    imply), and through ``ModelServer(sampler="distilled")``."""
    import base64

    from ldm3d_torch.cli.inference import main as inference_main
    from ldm3d_torch.ops import graphs
    from ldm3d_torch.serving.model_server import ModelServer

    argv = ["-c", cfg_path, "-e", str(env), "-n", "1", "--use-distilled", "--amp"]
    runs = {}
    for way, extra in (("eager", []), ("fused", ["--fused-decode"])):
        gc.collect()
        torch.cuda.empty_cache()
        timings: dict = {}
        before = graphs.launch_counts()
        unpin_precision(torch)
        written = inference_main(argv + extra, timings=timings)
        pinned_precision(torch, f"cli.inference.main --use-distilled {' '.join(extra)}")
        delta = graphs.launch_delta(graphs.launch_counts(), before)
        if way == "fused":
            delta = graphs.launch_delta(delta, timings["warmup_launches"][0])
        runs[way] = {"vols": _cli_volumes(written), "timings": timings,
                     "launches": _counts_by_key(delta)}
        shutil.rmtree(model_dir / "out")
    eager, fused = runs["eager"], runs["fused"]
    check(eager["vols"].shape == (1, 80, 80, 80) and bool(np.isfinite(eager["vols"]).all()),
          f"distilled sample: volumes {eager['vols'].shape}, finite "
          f"{bool(np.isfinite(eager['vols']).all())}")
    same = bool(np.array_equal(eager["vols"], fused["vols"]))
    check(same, "the fused distilled sample differs from the eager one by up to "
                f"{float(np.abs(eager['vols'] - fused['vols']).max())}")
    vae_attn = counts["encoder"]["attn"] + counts["decoder"]["attn"]
    want = {"flash_fwd": n_steps * counts["unet"]["attn"] + vae_attn,
            "gn_sums": counts["encoder"]["gn"] + n_steps * counts["unet"]["gn"]
            + counts["decoder"]["gn"]}
    for way, run in runs.items():
        for key, n in want.items():
            check(run["launches"][key] == n, f"distilled sample ({way}): {key} launched "
                                             f"{run['launches'][key]} times, expected {n}")
    server = ModelServer(cfg_path, str(env), sampler="distilled", device="cuda")
    unpin_precision(torch)
    server.load_model()
    pinned_precision(torch, "ModelServer.load_model (distilled)")
    check(not server.is_dummy and server.steps == n_steps,
          f"distilled server: dummy {server.is_dummy}, steps {server.steps}")
    t0 = time.perf_counter()
    reply = server.generate(num_samples=1, seed=0)
    serve_s = time.perf_counter() - t0
    vol = np.frombuffer(base64.b64decode(reply["samples"][0]["data"]), np.float32)
    check(reply["sampler"] == "distilled" and reply["inference_steps"] == n_steps
          and reply["timestep_spacing"] is None and vol.size == 80 ** 3
          and bool(np.isfinite(vol).all()), f"distilled server reply {reply['sampler']}, "
                                            f"{reply['inference_steps']} steps, {vol.size} voxels")
    try:
        server.generate(num_samples=1, seed=0, guidance_scale=2.0)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "guidance is unavailable" in refused,
          f"the distilled server took a guided request: {refused}")
    del server
    emit({"phase": "distill_sample", "config": "config_train_32g.json", "steps": n_steps,
          "dtype": "bfloat16", "bit_equal_fused_to_eager": same,
          "sample_ms": eager["timings"]["sample_ms"][0],
          "fused_sample_ms": fused["timings"]["sample_ms"][0],
          "fused_denoise_ms_per_step": fused["timings"]["denoise_ms"][0] / n_steps,
          "fused_decode_ms": fused["timings"]["decode_ms"][0],
          "launches_a_sample": eager["launches"], "serve_fp32_request_s": serve_s,
          "serve_refused_guidance": refused, "card": card, "nvidia_smi": smi_line})


@full_fp32
def phase_distill_card_vs_cpu(torch) -> None:
    """One ``config_tiny_cpu.json`` distillation step on the card (kernels)
    and on the CPU (plain): same weights, batch and draws, fp32 with TF32
    off; the loss, ``grad_norm`` and the student's gradients within
    TRAIN_GRAD_REL (the gradients of each leaf's largest |g|), the updated
    params within 2 lr + 1e-6; epsilon -> epsilon, and epsilon ->
    v_prediction with guidance 2.0."""
    import copy

    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (DistillConfig, DistillDraws, TrainState,
                                      make_diffusion_optimizer, make_distillation_step)

    cfg = load_json(preset_path("config_tiny_cpu.json"))
    ns = SimpleNamespace(**cfg)
    gen = torch.Generator().manual_seed(8)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval().requires_grad_(False)
    teacher = init_weights_(define_instance(ns, "diffusion_def"), gen).eval()
    with torch.no_grad():
        teacher.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    teacher.requires_grad_(False)
    b, patch = 2, cfg["diffusion_train"]["patch_size"]
    latent = (b, *[p // ae.downsample_factor for p in patch], cfg["latent_channels"])
    batch = {k: torch.rand((b, *patch, 1), generator=gen) for k in ("image", "label")}
    draws = DistillDraws(torch.randn(latent, generator=gen), torch.randn(latent, generator=gen),
                         torch.randn(latent, generator=gen), torch.tensor([0, 1]))
    sched = DDPMScheduler.create(num_train_timesteps=16)
    for kw in (dict(), dict(student_prediction_type="v_prediction", guidance_scale=2.0)):
        dcfg = DistillConfig(teacher_steps=4, **kw)
        out = {}
        for device in ("cuda", "cpu"):
            _reset_counts()
            t = copy.deepcopy(teacher).to(device)
            a = copy.deepcopy(ae).to(device)
            s = copy.deepcopy(teacher).to(device).requires_grad_(True).train()
            state = TrainState(s, make_diffusion_optimizer(s.parameters(), lambda count: TINY_LR))
            m = make_distillation_step(t, a, sched, dcfg)(
                state, t, {k: v.to(device) for k, v in batch.items()}, 0.9, draws=draws.to(device))
            out[device] = {"loss": float(m["distill_loss"]), "grad_norm": float(m["grad_norm"]),
                           "grads": {n: p.grad.cpu() for n, p in s.named_parameters()},
                           "params": {n: p.detach().cpu() for n, p in s.named_parameters()},
                           "teacher_grads": sum(p.grad is not None for p in t.parameters()),
                           "launches": _read_counts()}
        card, cpu = out["cuda"], out["cpu"]
        loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        norm_rel = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
        grad_worst = max((card["grads"][n] - g).abs().max().item()
                         / max(g.abs().max().item(), 1e-30) for n, g in cpu["grads"].items())
        param_worst = max((card["params"][n] - p).abs().max().item()
                          for n, p in cpu["params"].items())
        check(loss_rel <= TRAIN_GRAD_REL, f"card and CPU distillation losses differ by "
                                          f"{loss_rel} rel")
        check(norm_rel <= TRAIN_GRAD_REL, f"card and CPU gradient norms differ by {norm_rel} rel")
        check(grad_worst <= TRAIN_GRAD_REL, f"card and CPU student gradients differ by "
                                            f"{grad_worst} of a leaf's largest |g|")
        check(param_worst <= 2 * TINY_LR + 1e-6, f"card and CPU updated students differ by "
                                                  f"{param_worst}")
        check(card["teacher_grads"] == cpu["teacher_grads"] == 0, "a teacher got gradients")
        launched = card["launches"]
        check(all(launched[k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                             "gn_sums", "gn_bwd_sums")),
              f"a kernel did not run in the card's distillation step: {launched}")
        check(all(cpu["launches"][k] == 0 for k in ("flash_fwd", "gn_sums")),
              "the CPU step launched a kernel")
        emit({"phase": "distill_card_vs_cpu", "config": "config_tiny_cpu.json", "batch": b,
              "distill_config": {"teacher_steps": 4, **kw},
              "loss_card": card["loss"], "loss_cpu": cpu["loss"], "loss_rel_diff": loss_rel,
              "grad_norm_card": card["grad_norm"], "grad_norm_cpu": cpu["grad_norm"],
              "grad_norm_rel_diff": norm_rel, "grad_worst_rel_to_leaf_max": grad_worst,
              "param_max_abs_diff": param_worst,
              "tol": {"loss_rel": TRAIN_GRAD_REL, "grad_rel": TRAIN_GRAD_REL,
                      "param_abs": 2 * TINY_LR + 1e-6}, "card_launches": launched})


def phase_evaluate(torch, ns, workdir: Path, card: str, smi_line: str,
                   model_dir: Path | None = None) -> None:
    """``cli.evaluate`` at full width (fp32, ``-n 2 --batch 1``), on the
    distilled student (``--use-distilled``) and on DDIM-10, each writing its
    report; seconds a pair and the metrics' share beside the sampling's.
    Then ``ssim3d``, ``ms_ssim3d`` and ``latent_features`` (the flagship
    VAE) on seeded 80^3 volumes: on the card with both ``allow_tf32`` flags
    set True before the call, the same bits as with both False, and within
    EVAL_TOL of the CPU (the features within FEATURES_REL of their largest
    |value|). ``model_dir`` holds the
    flagship checkpoints and a distilled role (the distill phase's); run
    alone, the phase saves the flagship checkpoints with the best UNet's
    weights as a 2-step distilled role."""
    import copy

    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.cli.common import tf32_flags
    from ldm3d_torch.cli.evaluate import main as evaluate_main
    from ldm3d_torch.configs import preset_path
    from ldm3d_torch.evaluation import latent_features, ms_ssim3d, ssim3d
    from ldm3d_torch.training import student_timesteps

    cfg_path = preset_path("config_train_32g.json")
    if model_dir is None:
        model_dir, _ = _flagship_checkpoints(torch, ns, workdir)
        u_ckpt = CheckpointManager(str(model_dir), "diffusion")
        n_train = getattr(ns, "NoiseScheduler", {}).get("num_train_timesteps", 1000)
        u_ckpt.save("distilled", {"state_dict": u_ckpt.load("best")["state_dict"]},
                    {"timesteps": [int(t) for t in student_timesteps(n_train, 4)],
                     "num_steps": 2, "scale_factor": 0.8, "prediction_type": "epsilon",
                     "guidance_scale": 1.0})
    env = _write_env(model_dir, synthetic_num=TRAIN_PAIRS, resume_ckpt=False)
    for name, extra in (("distilled", ["--use-distilled"]),
                        ("ddim10", ["--sampler", "ddim", "--steps", "10"])):
        gc.collect()
        torch.cuda.empty_cache()
        report_path = model_dir / f"report_{name}.json"
        timings: dict = {}
        unpin_precision(torch)
        t0 = time.perf_counter()
        report = evaluate_main(["-c", cfg_path, "-e", str(env), "-n", str(EVAL_PAIRS),
                                "--batch", "1", "--report", str(report_path), *extra],
                               timings=timings)
        wall_s = time.perf_counter() - t0
        flags = pinned_precision(torch, f"cli.evaluate.main {' '.join(extra)}")
        saved = json.loads(report_path.read_text())
        check(report.num_samples == saved["num_samples"] == EVAL_PAIRS,
              f"evaluate {name}: {report.num_samples} pairs")
        check(all(math.isfinite(getattr(report, k)) for k in ("mae", "mse", "psnr", "ssim",
                                                               "ms_ssim", "score"))
              and report.frechet is not None and math.isfinite(report.frechet),
              f"evaluate {name}: non-finite report {saved}")
        sampling_ms = sum(timings["sample_ms"]) + sum(timings["encode_ms"])
        emit({"phase": "evaluate", "run": name, "config": "config_train_32g.json",
              "patch": [80, 80, 80], "pairs": EVAL_PAIRS, "dtype": "float32",
              "report": {k: saved[k] for k in ("mae", "mse", "psnr", "ssim", "ms_ssim",
                                               "frechet", "score")},
              "cli_wall_s": wall_s, "s_per_pair": wall_s / EVAL_PAIRS,
              "sample_ms": timings["sample_ms"], "encode_ms": timings["encode_ms"],
              "metrics_ms": timings["metrics_ms"],
              "metrics_share": timings["metrics_ms"] / (timings["metrics_ms"] + sampling_ms),
              "share_note": "metrics_ms (evaluate_pairs: the paired metrics and the VAE "
                            "features of both sets, to its result) over it plus the encodes' "
                            "and the samples' host ms; cli_wall_s also holds the checkpoint "
                            "loads and the data",
              "allow_tf32": flags, "card": card, "nvidia_smi": smi_line})

    gen = torch.Generator().manual_seed(12)
    x = torch.rand((2, 80, 80, 80, 1), generator=gen)
    y = torch.clamp(x + 0.1 * torch.randn(x.shape, generator=gen), 0, 1)
    ae = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(1))[0].eval()
    ae_cpu = copy.deepcopy(ae).cpu()
    rows = {}
    for name, fn in (("ssim3d", lambda d: ssim3d(x.to(d), y.to(d))),
                     ("ms_ssim3d", lambda d: ms_ssim3d(x.to(d), y.to(d))),
                     ("latent_features", lambda d: torch.from_numpy(
                         latent_features(ae if d == "cuda" else ae_cpu, x[:1])))):
        outs = {}
        for tag, device, flag in (("card_tf32_on", "cuda", True), ("card_tf32_off", "cuda", False),
                                  ("cpu", "cpu", False)):
            with tf32_flags(flag):
                outs[tag] = fn(device).cpu()
                check(torch.backends.cudnn.allow_tf32 == flag,
                      f"{name} left the caller's TF32 flags")
        largest = outs["cpu"].abs().max().item()
        rows[name] = {"max_abs_diff": (outs["card_tf32_on"] - outs["cpu"]).abs().max().item(),
                      "tf32_on_equals_off": torch.equal(outs["card_tf32_on"],
                                                        outs["card_tf32_off"]),
                      "max_abs_value": largest,
                      "tol": FEATURES_REL * largest if name == "latent_features" else EVAL_TOL}
    del ae, ae_cpu
    emit({"phase": "evaluate_card_vs_cpu", "shape": [2, 80, 80, 80, 1],
          "features_shape": [1, 80, 80, 80, 1], "metrics": rows,
          "tol_note": "the metrics (in [0, 1]) within EVAL_TOL; the features within "
                      "FEATURES_REL of their largest |value|: fp32 outputs of the full-width "
                      "encoder, whose convolutions the card and the CPU sum in other orders",
          "card": card, "nvidia_smi": smi_line})
    for name, r in rows.items():
        check(r["tf32_on_equals_off"], f"{name} on the card differs with the TF32 flags on")
        check(math.isfinite(r["max_abs_diff"]) and r["max_abs_diff"] <= r["tol"],
              f"{name}: card and CPU differ by {r['max_abs_diff']} (limit {r['tol']})")
    shutil.rmtree(model_dir)


# The presets phase: every bundled preset other than the flagship at its full
# width and patch. name -> (q/k/v layout of its export, the stage-2 and
# stage-1 runs go through the CLIs). 16g's VAE takes two image channels
# while the data pipeline gives one-channel crops: the JAX CLIs refuse both
# of its trainers (a 2-channel conv_in meets the first 1-channel crop), as
# the port's do, so its steps are the library's step functions on
# two-channel volumes at the preset's batch and patch, and its stage-1 step
# has no perceptual term (LPIPS takes one or three channels). pp's VAE is
# the flagship's, so it runs no stage-1 steps. stable's import derives the
# latent scale factor on the card (--derive-scale-factor) instead of taking it.
# "cli": the stage-2 and stage-1 runs go through the CLIs; "stage2_cli": False
# runs the stage-2 steps through the step function instead (multigpu's and
# pp's CLI runs wrote 10.7 and 18.6 GB checkpoints, about 40 s of the script's
# time limit; the CLI's stage-2 path runs at full width in phase 6 and here on
# stable)
PRESETS = {"config_train_16g.json": {"qkv": "split", "cli": False, "stage1": True,
                                     "samples": 1},
           "config_train_multigpu.json": {"qkv": "fused", "cli": True, "stage1": True,
                                          "stage2_cli": False},
           "config_train_stable.json": {"qkv": "split", "cli": True, "stage1": True,
                                        "derive": True},
           "config_train_pp.json": {"qkv": "fused", "cli": True, "stage1": False,
                                    "stage2_cli": False}}
PRESET_SAMPLE_STEPS = 10
# the first a warm-up: the figures are the second's; 16g samples once (its
# first sample is timed): each of its 2.84 M-voxel two-channel volumes takes
# about 25 s to gzip into its NIfTI file
PRESET_SAMPLES = 2
PRESET_TRAIN_STEPS = 3  # the first a warm-up: the figures are the median of the rest
PRESET_SCALE = 0.8


def _pairs_for_steps(batch: int, steps: int = PRESET_TRAIN_STEPS) -> int:
    """The fewest synthetic pairs whose training split (``val_fraction``
    0.1, ``data.pipeline._split``) fills exactly ``steps`` batches."""
    n = steps * batch
    while (n - int(0.1 * n)) // batch != steps:
        n += 1
    return n


def _attn_routes(torch, ns) -> dict:
    """Attention blocks per model part by head width, from models built on
    the meta device: {part: {d: count}}."""
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn.blocks import AttentionBlock3D

    with torch.device("meta"):
        ae = define_instance(ns, "autoencoder_def")
        unet = define_instance(ns, "diffusion_def")
    out = {}
    for part, mod in (("encoder", ae.encoder), ("decoder", ae.decoder), ("unet", unet)):
        widths: dict[int, int] = {}
        for m in mod.modules():
            if isinstance(m, AttentionBlock3D):
                d = m.proj.weight.shape[0] // m.heads
                widths[d] = widths.get(d, 0) + 1
        out[part] = widths
    return out


def _expected_routes(torch, widths: dict, weights: dict, bwd_weights: dict | None = None) -> dict:
    """Expected bf16 launches by kernel and route: ``weights`` (and
    ``bwd_weights`` for the backward) map a model part to its calls."""
    from ldm3d_torch.ops.attention import bwd_route_id, fwd_route_id

    exp: dict = {}
    for part, calls in weights.items():
        for d, n in widths[part].items():
            key = f"fwd:{fwd_route_id(torch.bfloat16, -(-d // 8) * 8)}"
            exp[key] = exp.get(key, 0) + calls * n
    for part, calls in (bwd_weights or {}).items():
        for d, n in widths[part].items():
            for kind in ("dq", "dkv"):
                key = f"{kind}:{bwd_route_id(torch.bfloat16, -(-d // 8) * 8)}"
                exp[key] = exp.get(key, 0) + calls * n
    return {k: v for k, v in exp.items() if v}


def _route_counts() -> dict:
    """The wrappers' launches by kernel and route since the last reset, in
    ``_expected_routes``'s keys (zero routes left out)."""
    from ldm3d_torch.ops.graphs import launch_counts

    c = launch_counts()
    out = {f"fwd:{r}": n for r, n in c["flash_attention_fwd"]["route_launches"].items() if n}
    for kind in ("dq", "dkv"):
        out.update({f"{kind}:{r}": n for r, n in
                    c[f"flash_attention_bwd_{kind}"]["route_launches"].items() if n})
    return out


def _check_launches(torch, name: str, what: str, expected_routes: dict,
                    expected_gn: dict) -> dict:
    routes, launches = _route_counts(), _read_counts()
    check(routes == expected_routes,
          f"{name} {what}: attention launches by route {routes}, expected {expected_routes}")
    for kernel, n in expected_gn.items():
        check(launches[kernel] == n, f"{name} {what}: {kernel} launched {launches[kernel]} "
                                     f"times, expected {n}")
    check(launches["conv3d_igemm"] == 0, f"{name} {what}: a conv kernel ran")
    return {"routes": routes, "launches": launches}


def _state_equal(torch, got: dict, want: dict) -> bool:
    return list(got) == list(want) and all(
        torch.equal(got[k].cpu(), v.detach().cpu()) for k, v in want.items())


def _preset_round_trip(torch, name: str, ns, root: Path, qkv: str, derive: bool) -> dict:
    """Seeded full-width models written by ``CheckpointManager``, exported by
    ``cli.export_checkpoint``, imported into a fresh model_dir by
    ``cli.import_checkpoint``: every imported tensor bit-equal. A
    ``mid_depth`` UNet's import is refused (no reference counterpart of its
    stack): that model_dir gets its ``best`` from the manager."""
    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.ckpt.import_torch import ImportMismatchError
    from ldm3d_torch.cli.common import save_two_stage
    from ldm3d_torch.cli.export_checkpoint import main as export_main
    from ldm3d_torch.cli.import_checkpoint import main as import_main
    from ldm3d_torch.configs import preset_path

    cfg_path = preset_path(name)
    ae, unet = _flagship_models(torch, ns, torch.Generator(device="cuda").manual_seed(11))
    src, dst = root / "src", root / "dst"
    t0 = time.perf_counter()
    save_two_stage(str(src), ae, unet, PRESET_SCALE)
    save_s = time.perf_counter() - t0
    env_src = _write_env(src)
    pts = {"autoencoder": root / "autoencoder.pt", "diffusion": root / "diffusion_unet.pt"}
    t0 = time.perf_counter()
    export_main(["-c", cfg_path, "-e", str(env_src), "--autoencoder", str(pts["autoencoder"]),
                 "--diffusion", str(pts["diffusion"]),
                 *(["--fused-qkv"] if qkv == "fused" else [])])
    export_s = time.perf_counter() - t0
    exported = {k: len(torch.load(p, map_location="cpu", weights_only=True, mmap=True))
                for k, p in pts.items()}
    batch = ns.diffusion_train["batch_size"]
    dst.mkdir()
    env_dst = _write_env(dst, synthetic_num=_pairs_for_steps(batch),
                         synthetic_shape=list(ns.diffusion_train["patch_size"]),
                         resume_ckpt=False)
    base = ["-c", cfg_path, "-e", str(env_dst)]
    t0 = time.perf_counter()
    mid = sum(k.startswith("mid_stack.") for k in unet.state_dict())
    if mid:
        try:
            import_main(base + ["--diffusion", str(pts["diffusion"]), "--scale-factor",
                                str(PRESET_SCALE)])
        except ImportMismatchError as e:
            refusal = str(e).splitlines()[0]
        else:
            raise RuntimeError(f"chip_smoke: {name}: the mid_depth UNet's import was not refused")
        check("mid_stack" in refusal, f"{name}: refused for another reason: {refusal}")
        import_main(base + ["--autoencoder", str(pts["autoencoder"])])
        CheckpointManager(str(dst), "diffusion").save(
            "best", {"state_dict": unet.state_dict()}, {"scale_factor": PRESET_SCALE})
    else:
        refusal = None
        scale = ["--derive-scale-factor"] if derive else ["--scale-factor", str(PRESET_SCALE)]
        import_main(base + ["--autoencoder", str(pts["autoencoder"]), "--diffusion",
                            str(pts["diffusion"]), *scale])
    import_s = time.perf_counter() - t0
    imported = {role: CheckpointManager(str(dst), role).load("best", map_location="cpu")
                for role in ("autoencoder", "diffusion")}
    check(_state_equal(torch, imported["autoencoder"]["state_dict"], ae.state_dict()),
          f"{name}: the imported autoencoder is not bit-equal to the exported model")
    check(_state_equal(torch, imported["diffusion"]["state_dict"], unet.state_dict()),
          f"{name}: the imported UNet is not bit-equal to the exported model")
    scale_factor = imported["diffusion"]["meta"]["scale_factor"]
    check(scale_factor != 1.0 and math.isfinite(scale_factor) and scale_factor > 0 if derive
          else scale_factor == PRESET_SCALE,
          f"{name}: imported meta {imported['diffusion']['meta']}")
    n_params = {"autoencoder": sum(p.numel() for p in ae.parameters()),
                "unet": sum(p.numel() for p in unet.parameters())}
    del ae, unet, imported
    shutil.rmtree(src)
    for p in pts.values():
        p.unlink()
    torch.cuda.empty_cache()
    return {"model_dir": dst, "env": env_dst, "params": n_params, "qkv": qkv,
            "exported_tensors": exported, "mid_stack_tensors_not_exported": mid,
            "unet_import_refusal": refusal, "scale_factor": scale_factor,
            "scale_factor_derived": derive, "save_s": save_s, "export_s": export_s,
            "import_s": import_s}


def _preset_sample(torch, name: str, ns, counts, widths, rt: dict, n: int) -> dict:
    """bf16 DDIM-10 through ``cli.inference`` from the imported model_dir:
    ``n`` samples, the last timed; exact launches by route."""
    from ldm3d_torch.cli.inference import main as inference_main
    from ldm3d_torch.configs import ConfigResolver, preset_path
    from ldm3d_torch.utils.nifti import read_nifti

    in_channels = ConfigResolver(vars(ns)).resolve("diffusion_def::in_channels")
    conditional = in_channels > ns.latent_channels
    argv = ["-c", preset_path(name), "-e", str(rt["env"]), "-n", str(n),
            "--sampler", "ddim", "--steps", str(PRESET_SAMPLE_STEPS), "--amp"]
    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    unpin_precision(torch)
    written = inference_main(argv, timings=timings)
    gn_cases = _read_gn_cases()
    flags = pinned_precision(torch, "cli.inference.main")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = PRESET_SAMPLE_STEPS
    weights = {"unet": n * steps, "decoder": n, "encoder": int(conditional)}
    expected_gn = {"gn_sums": sum(counts[p]["gn"] * w for p, w in weights.items()),
                   "gn_bwd_sums": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    rec = _check_launches(torch, name, "sampling", _expected_routes(torch, widths, weights),
                          expected_gn)
    patch = tuple(ns.diffusion_train["patch_size"])
    vol, _ = read_nifti(written[-1])
    want = patch if ns.image_channels == 1 else (*patch, ns.image_channels)
    check(len(written) == n and vol.shape == want and bool(np.isfinite(vol).all()),
          f"{name}: sampled {len(written)} volumes of shape {vol.shape}, expected {n} of {want}")
    return {"conditional": conditional, "sampler": f"ddim-{steps}", "dtype": "bfloat16",
            "samples": n, "timed": "the first (cold)" if n == 1 else "the last",
            "denoise_ms_per_step": timings["denoise_ms"][-1] / steps,
            "decode_ms": timings["decode_ms"][-1], "encode_ms": timings.get("encode_ms", []),
            "sample_ms": timings["sample_ms"][-1], "peak_device_memory_gib": peak_gib,
            "volume": list(vol.shape), "allow_tf32": flags, **rec, "gn_cases": gn_cases}


def _preset_train_cli(torch, name: str, ns, counts, widths, rt: dict) -> dict:
    """``PRESET_TRAIN_STEPS`` bf16 stage-2 steps through ``cli.train_diffusion``
    at the preset's batch and patch, over the imported VAE."""
    from ldm3d_torch.cli.train_diffusion import main as train_main
    from ldm3d_torch.configs import preset_path

    timings: dict = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    unpin_precision(torch)
    best_val = train_main(["-c", preset_path(name), "-e", str(rt["env"]), "--amp",
                           "--no-images", "--max-epochs", "1"], timings=timings)
    gn_cases = _read_gn_cases()
    flags = pinned_precision(torch, "cli.train_diffusion.main")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps, val = len(timings["train_step_ms"]), sum(timings["val_batches"])
    check(steps == PRESET_TRAIN_STEPS, f"{name}: {steps} stage-2 steps, expected "
                                       f"{PRESET_TRAIN_STEPS}")
    losses = timings["diffusion_loss"]
    check(all(math.isfinite(x) for x in losses) and math.isfinite(best_val),
          f"{name}: non-finite stage-2 losses {losses}, val {best_val}")
    encodes = 1 + 2 * steps + 2 * val
    weights = {"encoder": encodes, "unet": steps + val}
    expected_gn = {"gn_sums": sum(counts[p]["gn"] * w for p, w in weights.items()),
                   "gn_bwd_sums": steps * counts["unet"]["gn"]}
    rec = _check_launches(torch, name, "stage-2 training",
                          _expected_routes(torch, widths, weights, {"unet": steps}), expected_gn)
    return {"path": "cli.train_diffusion", "batch": ns.diffusion_train["batch_size"],
            "patch": ns.diffusion_train["patch_size"], "steps": steps, "val_batches": val,
            "train_step_ms": timings["train_step_ms"],
            "median_step_ms_after_first": statistics.median(timings["train_step_ms"][1:]),
            "diffusion_loss": losses, "scale_factor": timings["scale_factor"],
            "peak_device_memory_gib": peak_gib, "allow_tf32": flags, **rec,
            "gn_cases": gn_cases}


def _timed_steps(torch, step) -> list:
    out = []
    for _ in range(PRESET_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3, metrics))
    return out


def _preset_train_steps(torch, name: str, ns, counts, widths, rt: dict) -> dict:
    """``PRESET_TRAIN_STEPS`` bf16 stage-2 steps through
    ``make_stage2_train_step`` on random volumes of the preset's image
    channels at its batch and patch, over the imported VAE: conditional when
    the UNet takes the condition's channels (16g's is unconditional, on
    two-channel volumes, which the CLI's one-channel data does not give)."""
    from ldm3d_torch.cli.train_diffusion import load_frozen_autoencoder
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage2Config, TrainState, make_diffusion_optimizer,
                                      make_stage2_train_step)
    from ldm3d_torch.utils import TrainContext

    dt = torch.bfloat16
    args = SimpleNamespace(**vars(ns), model_dir=str(rt["model_dir"]))
    gen = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.reset_peak_memory_stats()
    ae = load_frozen_autoencoder(args, torch.device("cuda"), dt)
    with torch.device("cuda"):
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    unet.compute_dtype = dt
    state = TrainState(unet, make_diffusion_optimizer(unet.parameters(),
                                                      lambda count: ns.diffusion_train["lr"]))
    sched = TrainContext(ns).scheduler_config()
    conditional = unet.in_channels > ae.latent_channels
    step = make_stage2_train_step(unet, ae, DDPMScheduler.create(**sched),
                                  Stage2Config(conditional=conditional))
    b, patch = ns.diffusion_train["batch_size"], ns.diffusion_train["patch_size"]
    batch = {k: torch.rand((b, *patch, ns.image_channels), generator=gen, device="cuda")
             for k in ("image", "label")}
    _reset_counts()
    runs = _timed_steps(torch, lambda: step(state, batch, PRESET_SCALE, gen))
    gn_cases = _read_gn_cases()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(runs)
    losses = [float(m["diffusion_loss"]) for _, m in runs]
    check(all(math.isfinite(x) for x in losses), f"{name}: non-finite stage-2 losses {losses}")
    weights = {"encoder": (2 if conditional else 1) * steps, "unet": steps}
    expected_gn = {"gn_sums": sum(counts[p]["gn"] * w for p, w in weights.items()),
                   "gn_bwd_sums": steps * counts["unet"]["gn"]}
    rec = _check_launches(torch, name, "stage-2 steps",
                          _expected_routes(torch, widths, weights, {"unet": steps}), expected_gn)
    ms = [t for t, _ in runs]
    del state, unet, ae, batch
    torch.cuda.empty_cache()
    return {"path": "training.make_stage2_train_step (" + (
                "conditional" if conditional else "unconditional; the CLI refuses the "
                "preset's 2-channel VAE on 1-channel data, as the JAX CLI does") + ")",
            "conditional": conditional,
            "batch": b, "patch": patch, "image_channels": ns.image_channels, "steps": steps,
            "train_step_ms": ms, "median_step_ms_after_first": statistics.median(ms[1:]),
            "diffusion_loss": losses, "peak_device_memory_gib": peak_gib, **rec,
            "gn_cases": gn_cases}


def _preset_stage1(torch, name: str, ns, counts, widths, root: Path, via_cli: bool) -> dict:
    """``PRESET_TRAIN_STEPS`` adversarial bf16 stage-1 steps at the preset's
    batch and patch: through ``cli.train_autoencoder`` (a preset copy with
    warmup_epochs -1, so that its one epoch is adversarial, and one
    validation batch), or for 16g through ``make_stage1_train_step`` on
    two-channel volumes, without the perceptual term."""
    from ldm3d_torch.cli.train_autoencoder import build_discriminator
    from ldm3d_torch.cli.train_autoencoder import main as train_ae_main
    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage1Config, TrainState, make_optimizer,
                                      make_stage1_train_step)

    tc = ns.autoencoder_train
    attn = {"encoder": 1, "decoder": 1}
    vae_gn = counts["encoder"]["gn"] + counts["decoder"]["gn"]
    d_gn = counts["discriminator"]["gn"]
    torch.cuda.reset_peak_memory_stats()
    if via_cli:
        model_dir = root / "stage1"
        model_dir.mkdir()
        cfg = load_json(preset_path(name))
        cfg["autoencoder_train"].update(warmup_epochs=-1, val_interval=1, max_epochs=1)
        cfg_path = model_dir / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        env = _write_env(model_dir, synthetic_num=_pairs_for_steps(tc["batch_size"]),
                         synthetic_shape=list(tc["patch_size"]), resume_ckpt=False)
        timings: dict = {}
        _reset_counts()
        unpin_precision(torch)
        best_val = train_ae_main(["-c", str(cfg_path), "-e", str(env), "--amp", "--no-images"],
                                 timings=timings)
        gn_cases = _read_gn_cases()
        flags = pinned_precision(torch, "cli.train_autoencoder.main")
        steps, val = len(timings["train_step_ms"]), sum(timings["val_batches"])
        check(all(timings["adv_active"]) and steps == PRESET_TRAIN_STEPS and val == 1,
              f"{name}: stage-1 ran {timings['adv_active']} steps, {val} validation batches")
        losses = {k: timings[k] for k in ("g_loss", "d_loss")}
        check(all(math.isfinite(x) for v in losses.values() for x in v)
              and math.isfinite(best_val) and min(losses["d_loss"]) > 0,
              f"{name}: stage-1 losses {losses}, val {best_val}")
        ms = timings["train_step_ms"]
        shutil.rmtree(model_dir)
        path = "cli.train_autoencoder (warmup_epochs -1)"
    else:
        gen = torch.Generator(device="cuda").manual_seed(13)
        with torch.device("cuda"):
            ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
            disc = init_weights_(build_discriminator(ns), gen)
        ae.compute_dtype = disc.compute_dtype = torch.bfloat16
        g_state = TrainState(ae, make_optimizer(ae.parameters(), lambda count: tc["lr"]))
        d_state = TrainState(disc, make_optimizer(disc.parameters(), lambda count: tc["lr"]))
        step = make_stage1_train_step(ae, disc, None, Stage1Config(kl_weight=tc["kl_weight"],
                                                                   perceptual_weight=0.0))
        images = torch.rand((tc["batch_size"], *tc["patch_size"], ns.image_channels),
                            generator=gen, device="cuda")
        _reset_counts()
        runs = _timed_steps(torch, lambda: step(g_state, d_state, images, True, gen))
        gn_cases = _read_gn_cases()
        flags = None
        steps, val = len(runs), 0
        losses = {k: [float(m[k]) for _, m in runs] for k in ("g_loss", "d_loss")}
        check(all(math.isfinite(x) for v in losses.values() for x in v),
              f"{name}: stage-1 losses {losses}")
        ms = [t for t, _ in runs]
        del g_state, d_state, ae, disc, images
        path = ("training.make_stage1_train_step on 2-channel volumes, no perceptual term "
                "(LPIPS takes 1 or 3 channels)")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected_gn = {"gn_sums": vae_gn * (steps + val) + 3 * d_gn * steps,
                   "gn_bwd_sums": vae_gn * steps + 3 * d_gn * steps}
    rec = _check_launches(torch, name, "stage-1 training",
                          _expected_routes(torch, widths, {p: steps + val for p in attn},
                                           {p: steps for p in attn}), expected_gn)
    torch.cuda.empty_cache()
    return {"path": path, "batch": tc["batch_size"], "patch": tc["patch_size"], "steps": steps,
            "val_batches": val, "train_step_ms": ms,
            "median_step_ms_after_first": statistics.median(ms[1:]), "losses": losses,
            "peak_device_memory_gib": peak_gib, "allow_tf32": flags, **rec,
            "gn_cases": gn_cases}


def phase_presets(torch, workdir: Path, card: str, smi_line: str) -> dict:
    """Every preset of ``PRESETS`` at its full width and patch: the
    checkpoint round trip, a bf16 DDIM-10 sample, bf16 stage-2 steps and
    (but pp) bf16 adversarial stage-1 steps. Returns each preset's GroupNorm
    inputs by path (for the kernel_gn phase) and each run's launches."""
    from ldm3d_torch.configs import load_json, preset_path

    gn_paths, launches = {}, {}
    for name, opts in PRESETS.items():
        t0 = time.perf_counter()
        ns = SimpleNamespace(**load_json(preset_path(name)))
        counts = _module_counts(torch, ns)
        widths = _attn_routes(torch, ns)
        root = workdir / f"preset_{name.removesuffix('.json')}"
        rt = _preset_round_trip(torch, name, ns, root, opts["qkv"], opts.get("derive", False))
        emit({"phase": "presets", "config": name, "step": "checkpoint_round_trip",
              **{k: (str(v) if isinstance(v, Path) else v) for k, v in rt.items()
                 if k not in ("model_dir", "env")}, "bit_equal": True,
              "card": card, "nvidia_smi": smi_line})
        short = name.removeprefix("config_train_").removesuffix(".json")
        n = opts.get("samples", PRESET_SAMPLES)
        for what, run in (("sample", lambda: _preset_sample(torch, name, ns, counts, widths, rt,
                                                            n)),
                          ("stage2", lambda: (_preset_train_cli if opts.get("stage2_cli",
                                                                          opts["cli"]) else
                                              _preset_train_steps)(torch, name, ns, counts,
                                                                   widths, rt)),
                          *((("stage1", lambda: _preset_stage1(torch, name, ns, counts, widths,
                                                               root, opts["cli"])),)
                            if opts["stage1"] else ())):
            rec = run()
            gn_paths[f"presets_{short}_{what}"] = rec.pop("gn_cases")
            launches[f"{short}_{what}"] = rec["launches"]
            emit({"phase": "presets", "config": name, "step": what, **rec, "card": card,
                  "nvidia_smi": smi_line})
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        emit({"phase": "presets", "config": name, "step": "done",
              "seconds": time.perf_counter() - t0})
    return {"gn_paths": gn_paths, "launches": launches}


# --- phase 15: the trainers' follow-ups (remat, accumulation, profile, preemption) ---

REMAT_MODES = (None, "full", "convs")
# the one preset whose remat-wrapped UNet blocks hold attention (mid_stack):
# its stage-2 step with remat unset and ``full``
REMAT_ATTN_PRESET = "config_train_pp.json"
# the accumulated mean gradient against the batch-20 step's, relative to its
# largest |g|: sound fp32 readings 1.119e-5 to 1.877e-5 on one H100 (the
# batch-20 gradient's own fp32 sums at another batch size), planted faults
# (one micro-batch's gradient alone, the two summed unscaled) far above
ACCUM_TOL = 5e-5
# the stage-2 preemption run: config_train_stable's models at batch 2, so
# that an epoch of PREEMPT_PAIRS synthetic pairs has PREEMPT_STEPS steps
PREEMPT_PRESET = "config_train_stable.json"
PREEMPT_BATCH = 2
PREEMPT_PAIRS = 10
PREEMPT_STEPS = 4
# runs cli.train_diffusion in a subprocess and prints a marker after each
# training step, for the parent to send SIGTERM after the first
PREEMPT_RUNNER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import ldm3d_torch.cli.train_diffusion as td
make = td.make_stage2_train_step
def marked(*a, **k):
    step = make(*a, **k)
    def run(*args, **kwargs):
        out = step(*args, **kwargs)
        print("STEP_DONE", flush=True)
        return out
    return run
td.make_stage2_train_step = marked
td.main(sys.argv[2:])
"""


class _ClipInputs:
    """Records what each ``ClippedAdam`` hands to its clip (a step's
    gradients; under accumulation their running mean), copied to the host
    so that the copies take no device memory."""

    def __enter__(self):
        import torch

        import ldm3d_torch.training.state as S

        self.module, self.real, self.seen = S, S.clip_by_global_norm_, []

        def recording(tensors, max_norm, norm=None):
            self.seen.append([t.detach().to("cpu", torch.float32, copy=True) for t in tensors])
            return self.real(tensors, max_norm, norm)

        S.clip_by_global_norm_ = recording
        return self.seen

    def __exit__(self, *exc):
        self.module.clip_by_global_norm_ = self.real


class _MicroGrads:
    """Records the gradients each accumulating ``ClippedAdam`` micro-step
    hands in (its ``global_norm`` of them), copied to the host."""

    def __enter__(self):
        import torch

        import ldm3d_torch.training.state as S

        self.module, self.real, self.seen = S, S.global_norm, []

        def recording(tensors):
            tensors = list(tensors)
            if len(self.seen) < 2:
                self.seen.append([t.detach().to("cpu", torch.float32, copy=True)
                                  for t in tensors])
            return self.real(tensors)

        S.global_norm = recording
        return self.seen

    def __exit__(self, *exc):
        self.module.global_norm = self.real


def _grad_err(got: list, want: list) -> float:
    """The largest over tensors of max |got - want| / max |want|."""
    return max((e for e, _ in _grad_errs(got, want)), default=0.0)


def _grad_errs(got: list, want: list) -> list:
    """(max |got - want| / max |want|, index) of each tensor."""
    out = []
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        scale = float(w.abs().max())
        if scale > 0:
            out.append((float((g - w).abs().max()) / scale, i))
    return out


def _seed_conv_out(torch, unet, gen) -> None:
    """Seeded non-zero weights in the UNet's zero-init output conv, so that
    every layer's gradient is non-zero and the gradient checks hold them."""
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)


def _remat_recompute(torch, ns) -> dict:
    """GroupNorms and attention blocks (by head width) inside the blocks a
    remat mode wraps, per model part, from models built on the meta device:
    the forward launches a remated backward adds, once per step."""
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn.blocks import AttentionBlock3D, GroupNorm32

    with torch.device("meta"):
        ae = define_instance(ns, "autoencoder_def")
        unet = define_instance(ns, "diffusion_def")
    wrapped = {"unet": [getattr(unet, n) for kind, n in unet._down + unet._up if kind == "res"]
               + list(unet.mid_stack)}
    for part in ("encoder", "decoder"):
        stack = getattr(ae, part)
        wrapped[part] = [getattr(stack, n) for n, remat in stack._order if remat]
    out = {}
    for part, blocks in wrapped.items():
        gn, attn = 0, {}
        for m in (m for b in blocks for m in b.modules()):
            gn += isinstance(m, GroupNorm32)
            if isinstance(m, AttentionBlock3D):
                d = m.proj.weight.shape[0] // m.heads
                attn[d] = attn.get(d, 0) + 1
        out[part] = {"blocks": len(blocks), "gn": gn, "attn": attn}
    return out


def _add_routes(*dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


class _Deterministic:
    """cuDNN's deterministic algorithms inside the block (and its chosen
    flags back after): the gradient checks compare remat with no remat, not
    two runs of nondeterministic convolution backwards."""

    def __init__(self, torch):
        self.cudnn = torch.backends.cudnn

    def __enter__(self):
        self.before = self.cudnn.deterministic, self.cudnn.benchmark
        self.cudnn.deterministic, self.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        self.cudnn.deterministic, self.cudnn.benchmark = self.before


def _recorded_step(torch, step, init: dict, model, mode, make_states) -> dict:
    """One step of ``step`` under remat ``mode`` from the weights ``init``:
    the launches by kernel and route, the step's metrics and the gradients
    each optimizer was handed."""
    model.load_state_dict(init)
    model.remat = mode
    states = make_states()
    torch.cuda.synchronize()
    _reset_counts()
    with _ClipInputs() as grads:
        metrics = step(*states)
        torch.cuda.synchronize()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "routes": _route_counts(),
            "launches": _read_counts(), "grads": grads}


def _remat_timed_steps(torch, step, init: dict, model, make_states, modes: tuple,
                       steps: int = 3) -> dict:
    """Each remat mode's ms a step (host clock to a device sync; the median
    of ``steps`` steps after one warm-up step each) and peak device memory
    over those steps, on one optimizer state from the weights ``init``."""
    model.load_state_dict(init)
    states = make_states()  # one optimizer state for every mode's steps
    times = {mode: [] for mode in modes}
    out = {}
    for mode in modes:  # one warm-up step each
        model.remat = mode
        step(*states)
    for mode in modes:
        model.remat = mode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*states)
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
        out[str(mode)] = {"ms": statistics.median(times[mode]), "step_ms": times[mode],
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return out


def _remat_runs(torch, name: str, step, model, make_states, expected, tol: float,
                names: list, modes: tuple = REMAT_MODES) -> dict:
    """The unremated step (after one warm-up) and each remat mode of ``modes``'s, all
    from the same weights and draws, with cuDNN's deterministic algorithms:
    every optimizer's gradients and the step's metrics within ``tol`` of the
    unremated step's (relative to each tensor's largest |g|), and the
    launches by kernel and route exactly ``expected(mode)``. A second
    unremated step gives the run-to-run spread. Then each mode's ms a step
    and peak memory with the flags as the run set them
    (:func:`_remat_timed_steps`). ``names``: each optimizer's parameter names."""
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.remat = None
    step(*make_states())  # warm-up: kernel plans, cuDNN's choices
    with _Deterministic(torch):
        runs = {str(m): _recorded_step(torch, step, init, model, m, make_states)
                for m in modes}
        again = _recorded_step(torch, step, init, model, None, make_states)
    ref = runs["None"]

    def compare(r: dict) -> dict:
        errs = sorted(((e, f"{k}:{names[k][i]}") for k, (g, w) in enumerate(
            zip(r["grads"], ref["grads"], strict=True)) for e, i in _grad_errs(g, w)),
            reverse=True)
        metric_errs = {k: abs(r["metrics"][k] - v) / max(abs(v), 1e-30)
                       for k, v in ref["metrics"].items()}
        return {"max_grad_err_rel": errs[0][0] if errs else 0.0, "worst_grads": errs[:5],
                "metric_errs": metric_errs, "tol": tol, "metrics": r["metrics"],
                "routes": r["routes"], "launches": r["launches"]}

    out = {mode: compare(r) for mode, r in runs.items()}
    out["spread"] = compare(again)
    for mode in modes:
        rec = out[str(mode)]
        metric_err = max(v for k, v in rec["metric_errs"].items() if "grad_norm" not in k)
        check(rec["max_grad_err_rel"] <= tol and metric_err <= tol,
              f"{name} remat {mode}: gradients {rec['max_grad_err_rel']:.3e} of the unremated "
              f"step's (worst {rec['worst_grads']}), metrics {rec['metric_errs']}, over "
              f"{tol:.3e}; two unremated runs: {out['spread']['max_grad_err_rel']:.3e}")
        routes, gn = expected(mode)
        check(rec["routes"] == routes, f"{name} remat {mode}: attention launches by route "
                                       f"{rec['routes']}, expected {routes}")
        for kernel, n in gn.items():
            check(rec["launches"][kernel] == n, f"{name} remat {mode}: {kernel} launched "
                                                f"{rec['launches'][kernel]} times, expected {n}")
        check(rec["launches"]["conv3d_igemm"] == 0, f"{name} remat {mode}: a conv kernel ran")
    for mode, timed in _remat_timed_steps(torch, step, init, model, make_states,
                                          modes).items():
        out[mode].update(timed)
    model.load_state_dict(init)
    model.remat = False
    return out


def _follow_stage2_remat(torch, ns, counts, rec, widths, config: str = "config_train_32g.json",
                         modes: tuple = REMAT_MODES) -> dict:
    """bf16 stage-2 steps of ``config``'s full-width models at its batch and
    patch (``make_stage2_train_step``, conditional) under each remat mode of
    ``modes``."""
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage2Config, TrainState, draw_stage2,
                                      make_diffusion_optimizer, make_stage2_train_step)
    from ldm3d_torch.utils import TrainContext

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(15)
    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval()
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    _seed_conv_out(torch, unet, gen)
    ae.requires_grad_(False)
    ae.compute_dtype = unet.compute_dtype = dt
    cfg = Stage2Config()
    scheduler = DDPMScheduler.create(**TrainContext(ns).scheduler_config())
    b, patch = ns.diffusion_train["batch_size"], ns.diffusion_train["patch_size"]
    batch = {k: torch.rand((b, *patch, ns.image_channels), generator=gen, device="cuda")
             for k in ("image", "label")}
    f = ae.downsample_factor
    draws = draw_stage2(gen, (b, *[p // f for p in patch], ae.latent_channels),
                        scheduler.num_train_timesteps, cfg, "cuda")
    step = make_stage2_train_step(unet, ae, scheduler, cfg)
    lr = ns.diffusion_train["lr"]

    def make_states():
        return (TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda c: lr)),)

    def run(state):
        return step(state, batch, PRESET_SCALE, draws=draws)

    def expected(mode):
        routes = _expected_routes(torch, widths, {"encoder": 2, "unet": 1}, {"unet": 1})
        gn = {"gn_sums": 2 * counts["encoder"]["gn"] + counts["unet"]["gn"],
              "gn_bwd_sums": counts["unet"]["gn"]}
        if mode:
            routes = _add_routes(routes, _expected_routes(
                torch, {"unet": rec["unet"]["attn"]}, {"unet": 1}))
            gn["gn_sums"] += rec["unet"]["gn"]
        return routes, gn

    names = [[n for n, p in unet.named_parameters() if p.requires_grad]]
    out = _remat_runs(torch, f"stage-2 bf16 {config}", run, unet, make_states, expected,
                      2.0 ** -7, names, modes)
    del ae, unet, batch, draws
    gc.collect()
    torch.cuda.empty_cache()
    return {"path": f"training.make_stage2_train_step (conditional), {config}, bf16",
            "batch": b, "patch": patch,
            "recomputed_per_step": rec["unet"], "modes": out}


def _follow_stage1_remat(torch, ns, counts, rec, widths) -> dict:
    """One adversarial bf16 stage-1 step of the full-width 32g VAE against
    the CLI's discriminator and LPIPS, at batch 1 on a 64^3 patch, with
    remat unset, ``full`` and ``convs``; G's and D's gradients held."""
    from ldm3d_torch.cli.train_autoencoder import build_discriminator, build_lpips
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage1Config, TrainState, draw_stage1, make_optimizer,
                                      make_stage1_train_step)

    dt = torch.bfloat16
    tc = ns.autoencoder_train
    gen = torch.Generator(device="cuda").manual_seed(16)
    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        disc = init_weights_(build_discriminator(ns), gen)
    ae.compute_dtype = disc.compute_dtype = dt
    lpips = build_lpips(SimpleNamespace(lpips_weights=""), dt, torch.device("cuda"))
    cfg = Stage1Config(kl_weight=tc["kl_weight"], perceptual_weight=tc["perceptual_weight"])
    images = torch.rand((tc["batch_size"], *tc["patch_size"], ns.image_channels),
                        generator=gen, device="cuda")
    f = ae.downsample_factor
    draws = draw_stage1(gen, (tc["batch_size"], *[p // f for p in tc["patch_size"]],
                              ae.latent_channels), images.shape, cfg, "cuda")
    d_init = {k: v.detach().clone() for k, v in disc.state_dict().items()}
    step = make_stage1_train_step(ae, disc, lpips, cfg)

    def make_states():
        disc.load_state_dict(d_init)
        return (TrainState(ae, make_optimizer(ae.parameters(), lambda c: tc["lr"])),
                TrainState(disc, make_optimizer(disc.parameters(), lambda c: tc["lr"])))

    def run(g_state, d_state):
        return step(g_state, d_state, images, True, draws=draws)

    vae_gn = counts["encoder"]["gn"] + counts["decoder"]["gn"]
    d_gn = counts["discriminator"]["gn"]

    def expected(mode):
        parts = {"encoder": 1, "decoder": 1}
        routes = _expected_routes(torch, widths, parts, parts)
        gn = {"gn_sums": vae_gn + 3 * d_gn, "gn_bwd_sums": vae_gn + 3 * d_gn}
        if mode:
            routes = _add_routes(routes, *(_expected_routes(
                torch, {p: rec[p]["attn"]}, {p: 1}) for p in parts))
            gn["gn_sums"] += rec["encoder"]["gn"] + rec["decoder"]["gn"]
        return routes, gn

    names = [[n for n, p in m.named_parameters() if p.requires_grad] for m in (ae, disc)]
    out = _remat_runs(torch, "stage-1 bf16", run, ae, make_states, expected, 2.0 ** -7,
                      names)
    del ae, disc, lpips, images
    gc.collect()
    torch.cuda.empty_cache()
    return {"path": "training.make_stage1_train_step (adversarial, LPIPS), "
                    "config_train_32g.json, bf16", "batch": tc["batch_size"],
            "patch": tc["patch_size"],
            "recomputed_per_step": {p: rec[p] for p in ("encoder", "decoder")}, "modes": out}


def _follow_accumulation(torch, ns) -> dict:
    """fp32 (TF32 off, cuDNN's deterministic algorithms) stage-2 step of the
    full-width 32g models: the mean gradient ``--grad-accum 2`` hands to
    clip and Adam over the two halves of a batch of 20 (the batch-20 draws
    split in halves) against the gradient of one step on the whole batch,
    within ``ACCUM_TOL`` of that gradient's largest |g| (over every tensor);
    each tensor's own worst share is reported beside it. Two planted faults
    computed from the same micro-batch gradients (one half's gradient
    alone, as if the same half ran twice; the two summed without the 1/k)
    must read above ``ACCUM_TOL``, so that the check can fail."""
    from ldm3d_torch.cli.common import tf32_flags
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.diffusion import DDPMScheduler
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage2Config, Stage2Draws, TrainState, draw_stage2,
                                      make_diffusion_optimizer, make_stage2_train_step)
    from ldm3d_torch.utils import TrainContext

    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval()
        unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    _seed_conv_out(torch, unet, gen)
    ae.requires_grad_(False)
    cfg = Stage2Config()
    scheduler = DDPMScheduler.create(**TrainContext(ns).scheduler_config())
    b, patch = ns.diffusion_train["batch_size"], ns.diffusion_train["patch_size"]
    half = b // 2
    batch = {k: torch.rand((b, *patch, ns.image_channels), generator=gen, device="cuda")
             for k in ("image", "label")}
    f = ae.downsample_factor
    draws = draw_stage2(gen, (b, *[p // f for p in patch], ae.latent_channels),
                        scheduler.num_train_timesteps, cfg, "cuda")

    def halves(i):
        sl = slice(i * half, (i + 1) * half)
        return ({k: v[sl] for k, v in batch.items()},
                Stage2Draws(*(None if t is None else t[sl] for t in (
                    draws.eps_label, draws.eps_image, draws.noise, draws.timesteps,
                    draws.keep))))

    step = make_stage2_train_step(unet, ae, scheduler, cfg)
    init = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    lr = ns.diffusion_train["lr"]
    times = {}
    with tf32_flags(False), _Deterministic(torch):
        state = TrainState(unet, make_diffusion_optimizer(unet.parameters(), lambda c: lr))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ClipInputs() as whole:
            step(state, batch, PRESET_SCALE, draws=draws)
            torch.cuda.synchronize()
        times["batch_step_ms"] = (time.perf_counter() - t0) * 1e3
        unet.load_state_dict(init)
        opt = make_diffusion_optimizer(unet.parameters(), lambda c: lr, grad_accum=2)
        state = TrainState(unet, opt, ema_decay=0.999, ema_every=2)
        norms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _ClipInputs() as mean, _MicroGrads() as micro:
            for i in range(2):
                hb, hd = halves(i)
                norms.append(float(step(state, hb, PRESET_SCALE, draws=hd)["grad_norm"]))
                if i == 0:
                    check(not opt.adam.state and opt.mini_step == 1 and not mean,
                          "--grad-accum 2 updated or clipped on its first micro-step")
            torch.cuda.synchronize()
        times["two_micro_steps_ms"] = (time.perf_counter() - t0) * 1e3
    check(len(whole) == 1 and len(mean) == 1 and opt.mini_step == 0 and state.step == 2
          and all(int(s["step"]) == 1 for s in opt.adam.state.values()),
          "--grad-accum 2 did not emit exactly one update on its second micro-step")
    names = [n for n, p in unet.named_parameters() if p.requires_grad]
    largest = max(float(w.abs().max()) for w in whole[0])

    def err_to(got, ref) -> float:
        return max(float((g.double() - w.double()).abs().max())
                   for g, w in zip(got, ref, strict=True)) / largest

    check(len(micro) == 2, f"{len(micro)} micro-step gradients recorded, not 2")
    # the exact (fp64) mean of the two micro-batches' own gradients
    exact = [(a.double() + b.double()) / 2 for a, b in zip(micro[0], micro[1], strict=True)]
    err = err_to(mean[0], whole[0])
    accum_err = err_to(mean[0], exact)
    spread = err_to(whole[0], exact)
    faults = {"one_half_alone": err_to(micro[0], whole[0]),
              "summed_unscaled": err_to([a.double() + b.double() for a, b in
                                         zip(micro[0], micro[1])], whole[0])}
    per_tensor = sorted(((e, names[i]) for e, i in _grad_errs(mean[0], whole[0])),
                        reverse=True)[:5]
    # the accumulator's own arithmetic: 1e-6 of the largest |g|
    check(accum_err <= 1e-6,
          f"--grad-accum 2 mean gradient {accum_err:.3e} of the largest |g| from the exact mean "
          "of its micro-batches' gradients, over 1e-6")
    check(err <= ACCUM_TOL,
          f"--grad-accum 2 mean gradient {err:.3e} of the batch-20 gradient's largest |g|, over "
          f"{ACCUM_TOL:.0e} (worst tensors, each to its own largest |g|: {per_tensor})")
    check(min(faults.values()) > ACCUM_TOL,
          f"a planted accumulation fault reads within {ACCUM_TOL:.0e}: {faults}")
    unet.load_state_dict(init)
    del ae, unet, batch, draws, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"path": "training.make_stage2_train_step (conditional), config_train_32g.json, "
                    "fp32, TF32 off", "batch": b, "micro_batch": half, "grad_accum": 2,
            "max_grad_err_rel": err, "accumulator_vs_exact_mean": accum_err,
            "batch20_vs_exact_mean": spread, "largest_abs_grad": largest, "tol": ACCUM_TOL,
            "within_1e-5": err <= 1e-5, "planted_faults": faults,
            "worst_tensors_rel_to_own_largest": per_tensor, "micro_grad_norms": norms,
            **times}


def _follow_profile(torch, workdir: Path) -> dict:
    """``cli.train_autoencoder`` over the 32g config at one ResBlock a level
    (warmup_epochs -1) for 5 bf16 steps with ``--profile --remat convs
    --grad-accum 2 --track --debug-nans``: the trace exists and names the
    GroupNorm sums kernel, the run is tracked."""
    from ldm3d_torch.cli.train_autoencoder import main as train_ae_main
    from ldm3d_torch.configs import load_json, preset_path

    run_dir = workdir / "follow_profile"
    run_dir.mkdir()
    cfg = load_json(preset_path("config_train_32g.json"))
    cfg["autoencoder_def"]["num_res_blocks"] = 1
    cfg["autoencoder_train"].update(warmup_epochs=-1, val_interval=1, max_epochs=1)
    cfg_path = run_dir / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    steps = 5
    env = _write_env(run_dir, synthetic_num=_pairs_for_steps(1, steps),
                     synthetic_shape=list(AE_PATCH), resume_ckpt=False)
    timings: dict = {}
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        t0 = time.perf_counter()
        train_ae_main(["-c", str(cfg_path), "-e", str(env), "--amp", "--no-images",
                       "--profile", "--remat", "convs", "--grad-accum", "2", "--track",
                       "--experiment", "follow-ups", "--debug-nans"], timings=timings)
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    check(len(timings["train_step_ms"]) == steps and all(timings["adv_active"]),
          f"the profiled stage-1 run ran {timings['adv_active']} steps")
    check(not torch.is_anomaly_enabled(), "--debug-nans stayed on after the CLI returned")
    traces = sorted((run_dir / "profiler_logs").glob("*.json"))
    check(len(traces) == 1, f"--profile wrote {len(traces)} traces")
    trace = json.loads(traces[0].read_text())
    kernels = sorted({e.get("name", "") for e in trace.get("traceEvents", [])
                      if e.get("cat") == "kernel"})
    gn_kernels = [k for k in kernels if "gn_sums_onepass" in k]
    check(gn_kernels, f"the --profile trace names no gn_sums_onepass kernel: {kernels[:20]}")
    tracked = list((run_dir / "mlruns_local" / "follow-ups").glob("*/meta.json"))
    check(len(tracked) == 1 and json.loads(tracked[0].read_text())["status"] == "FINISHED",
          "--track recorded no finished run")
    out = {"steps": steps, "run_s": run_s, "train_step_ms": timings["train_step_ms"],
           "trace_mb": traces[0].stat().st_size / 1e6, "trace_kernel_names": len(kernels),
           "gn_kernels": gn_kernels, "tracked": True}
    shutil.rmtree(run_dir)
    return out


def _run_marked(cmd: list, cwd: Path, signal_after_first_step: bool,
                timeout_s: float = 420.0) -> tuple[int, str, int]:
    """Run ``cmd``; with ``signal_after_first_step`` send SIGTERM at the
    first step marker. Returns (exit code, output, markers seen)."""
    import signal
    import threading

    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    watchdog = threading.Timer(timeout_s, proc.kill)
    watchdog.start()
    lines, marks = [], 0
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.strip() == "STEP_DONE":
                marks += 1
                if marks == 1 and signal_after_first_step:
                    proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, "".join(lines), marks


def _follow_preemption(torch, workdir: Path) -> dict:
    """A bf16 stage-2 CLI run in a subprocess (config_train_stable's models
    at batch 2, ``--remat full --grad-accum 2``) gets SIGTERM after its
    first step: exit 75, a resumable ``last`` with the JAX trainer's meta;
    then a resumed run (``--track --debug-nans``, and ``--profile``, which
    stage 2 accepts and ignores as JAX's does) replays epoch 0 and
    finishes, writing no trace."""
    from ldm3d_torch.ckpt import CheckpointManager
    from ldm3d_torch.configs import define_instance, load_json, preset_path
    from ldm3d_torch.nn import init_weights_

    run_dir = workdir / "follow_preempt"
    run_dir.mkdir()
    cfg = load_json(preset_path(PREEMPT_PRESET))
    cfg["diffusion_train"].update(batch_size=PREEMPT_BATCH, max_epochs=2, val_interval=1)
    cfg_path = run_dir / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    env = _write_env(run_dir, synthetic_num=PREEMPT_PAIRS,
                     synthetic_shape=list(cfg["diffusion_train"]["patch_size"]),
                     resume_ckpt=False)
    with torch.device("cuda"):
        ae = init_weights_(define_instance(SimpleNamespace(**cfg), "autoencoder_def"),
                           torch.Generator(device="cuda").manual_seed(18))
    CheckpointManager(str(run_dir), "autoencoder").save("best", {"state_dict": ae.state_dict()})
    del ae
    torch.cuda.empty_cache()
    flags = ["-c", str(cfg_path), "-e", str(env), "--amp", "--no-images", "--remat", "full",
             "--grad-accum", "2"]
    t0 = time.perf_counter()
    rc, log, marks = _run_marked([sys.executable, "-c", PREEMPT_RUNNER, str(ROOT), *flags],
                                 run_dir, signal_after_first_step=True)
    first_s = time.perf_counter() - t0
    check(rc == 75, f"the SIGTERM'd stage-2 CLI exited {rc}, not 75: {log[-3000:]}")
    mgr = CheckpointManager(str(run_dir), "diffusion")
    meta = mgr.load_meta("last")
    last = mgr.load("last", map_location="cpu")
    stopped_after = int(last["step"])
    check(set(meta) == {"epoch", "best_val", "scale_factor", "preempted"}
          and meta["epoch"] == -1 and meta["preempted"] is True
          and 1 <= stopped_after == marks < PREEMPT_STEPS,
          f"preempted 'last': meta {meta}, {stopped_after} steps saved, {marks} steps run")
    check(last["optimizer"]["accum"]["mini_step"] == stopped_after % 2,
          "the preempted 'last' lost the accumulation state")
    env_data = json.loads(Path(env).read_text())
    env_data["resume_ckpt"] = True
    Path(env).write_text(json.dumps(env_data))
    t0 = time.perf_counter()
    rc2, log2, marks2 = _run_marked([sys.executable, "-c", PREEMPT_RUNNER, str(ROOT), *flags,
                                     "--max-epochs", "1", "--track", "--experiment",
                                     "follow-ups", "--debug-nans", "--profile"], run_dir,
                                    signal_after_first_step=False)
    resume_s = time.perf_counter() - t0
    check(rc2 == 0, f"the resumed stage-2 CLI exited {rc2}: {log2[-3000:]}")
    meta2 = mgr.load_meta("last")
    steps2 = int(mgr.load("last", map_location="cpu")["step"])
    check(meta2["epoch"] == 0 and "preempted" not in meta2
          and marks2 == PREEMPT_STEPS and steps2 == stopped_after + PREEMPT_STEPS,
          f"the resumed run: meta {meta2}, {marks2} steps run, {steps2} saved")
    check(len(list((run_dir / "mlruns_local" / "follow-ups").glob("*/meta.json"))) == 1,
          "the resumed run was not tracked")
    check(not (run_dir / "profiler_logs").exists(), "stage 2 wrote a --profile trace")
    shutil.rmtree(run_dir)
    return {"preset": PREEMPT_PRESET, "batch": PREEMPT_BATCH,
            "steps_per_epoch": PREEMPT_STEPS, "stopped_after_steps": stopped_after,
            "exit_code": rc, "preempted_meta": meta, "resumed_exit_code": rc2,
            "resumed_steps": marks2, "first_run_s": first_s, "resumed_run_s": resume_s}


def _follow_prefetch(torch) -> dict:
    """``data.device_prefetch`` on the card: batches arrive in order, on the
    device, equal to the host arrays."""
    from ldm3d_torch.data import device_prefetch

    host = [{"image": np.random.default_rng(i).random((2, 32, 32, 32, 1), np.float32)}
            for i in range(6)]
    got = list(device_prefetch(iter(host), size=2, device="cuda"))
    check(len(got) == len(host) and all(
        g["image"].is_cuda and np.array_equal(g["image"].cpu().numpy(), h["image"])
        for g, h in zip(got, host)), "device_prefetch changed or reordered a batch")
    return {"batches": len(got)}


def phase_follow_ups(torch, ns, counts, workdir: Path, card: str, smi_line: str) -> dict:
    """15. The trainers' follow-ups on the card (see the module docstring);
    one line a part as it ends, then the phase's line."""
    from ldm3d_torch.configs import load_json, preset_path

    t0 = time.perf_counter()
    rec, widths = _remat_recompute(torch, ns), _attn_routes(torch, ns)
    pp = SimpleNamespace(**load_json(preset_path(REMAT_ATTN_PRESET)))
    pp_rec = _remat_recompute(torch, pp)
    check(sum(pp_rec["unet"]["attn"].values()) > 0,
          f"{REMAT_ATTN_PRESET}'s remat-wrapped UNet blocks hold no attention")
    parts = (("stage2_remat", lambda: _follow_stage2_remat(torch, ns, counts, rec, widths)),
             ("stage2_pp_remat", lambda: _follow_stage2_remat(
                 torch, pp, _module_counts(torch, pp), pp_rec, _attn_routes(torch, pp),
                 REMAT_ATTN_PRESET, (None, "full"))),
             ("stage1_remat", lambda: _follow_stage1_remat(torch, ns, counts, rec, widths)),
             ("accumulation", lambda: _follow_accumulation(torch, ns)),
             ("profile", lambda: _follow_profile(torch, workdir)),
             ("preemption", lambda: _follow_preemption(torch, workdir)),
             ("prefetch", lambda: _follow_prefetch(torch)))
    out = {}
    for part, run in parts:
        t_part = time.perf_counter()
        out[part] = run()
        out[part]["seconds"] = time.perf_counter() - t_part
        emit({"phase": f"follow_ups_{part}", "card": card, "nvidia_smi": smi_line,
              **out[part]})
    emit({"phase": "follow_ups", "card": card, "nvidia_smi": smi_line,
          "seconds": time.perf_counter() - t0,
          **{part: {k: v for k, v in r.items() if k in ("seconds", "max_grad_err_rel")}
             for part, r in out.items()}})
    per_step = {run: {mode: r["launches"] for mode, r in out[f"{run}_remat"]["modes"].items()
                      if mode != "spread"}
                for run in ("stage2", "stage2_pp", "stage1")}
    return {"launches_per_step": per_step}


# --- phase 16: data tools, the system advisor and the training pipeline ---

DATA_PATCH = (96, 96, 96)
# ragged volumes around 96^3 in every input format; the low and high volumes
# of a pair share a shape (prepare_data refuses a mismatch)
DATA_VOLUMES = (((100, 92, 96), "npy"), ((96, 104, 90), "npz"), ((90, 96, 100), "nii"),
                ((104, 100, 92), "npy"), ((92, 90, 104), "npz"), ((96, 96, 96), "nii"),
                ((98, 94, 102), "npy"), ((94, 102, 98), "npz"))
# 6 training pairs (3 steps of batch 2) and 2 validation pairs (one batch)
DATA_VAL_FRACTION = 0.25
DATA_ATTN_SHAPE = (2, 13824, 1, 256)  # the VAE's mid-attention at batch 2, 96^3
SCALE_TOL = 1e-6
CALIBRATION_STEPS = 2  # the peak of the second step: Adam's moments exist by then
# the advisor's memory model against a measured peak (the allocator's part):
# each calibration point and each recipe run within 5 % of the model
MODEL_TOL = 0.05
# the smaller card whose recipe runs under a per-process cap on this one
SMALL_CARD_BYTES = 16 * 2**30


def _outside_allocator_bytes(torch) -> int:
    """Device memory this process holds outside PyTorch's caching allocator:
    the CUDA context, the loaded kernel modules and the libraries' handles."""
    free, total = torch.cuda.mem_get_info()
    return total - free - torch.cuda.memory_reserved()


def _empty_allocator(torch) -> int:
    """Free the allocator's cached blocks, restart its peaks and return the
    bytes it still reserves (blocks that live tensors of earlier phases hold),
    so that a run's own peak is ``max_memory_reserved()`` less it."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_reserved()


def _attn_cases() -> dict:
    """The attention wrappers' launches by input since the last reset:
    {"fwd" | "bwd": {(shape[, kv_len], dtype): launches}}, a shape as the
    kernel phases write it (kv_len only where it is not n)."""
    from ldm3d_torch.ops import attention as A

    def keyed(cases):
        return {((*shape, kv) if kv != shape[1] else tuple(shape), dtype): n
                for (shape, kv, dtype), n in cases.items()}

    return {"fwd": keyed(A.flash_attention_fwd.cases),
            "bwd": keyed(A.flash_attention_bwd_dq.cases)}


def _data_volumes(root: Path) -> tuple[Path, Path]:
    from ldm3d_torch.utils.nifti import write_nifti

    rng = np.random.default_rng(16)
    low, high = root / "low", root / "high"
    low.mkdir(parents=True)
    high.mkdir()
    for i, (shape, fmt) in enumerate(DATA_VOLUMES):
        for d, scale in ((low, 40.0), (high, 100.0)):
            vol = (rng.gamma(2.0, scale, shape)).astype(np.float32)
            stem = d / f"subject_{i:02d}"
            if fmt == "npy":
                np.save(f"{stem}.npy", vol)
            elif fmt == "npz":
                np.savez_compressed(f"{stem}.npz", vol)
            else:
                write_nifti(f"{stem}.nii", vol)
    return low, high


def _data_prepare(torch, root: Path) -> dict:
    """``cli.prepare_data`` over the ragged volumes, fitted to DATA_PATCH;
    every written pair read through the native library (the dataset's
    counter must count each file once, on the native path) and held bit for
    bit to the numpy path; ``load_batch`` of all of them; then
    ``scale_intensity_percentiles`` on the card against the CPU."""
    from ldm3d_torch.cli.prepare_data import main as prepare_main
    from ldm3d_torch.data import native_loader, npz_dataset
    from ldm3d_torch.data.transforms import scale_intensity_percentiles

    low, high = _data_volumes(root)
    out = root / "dataset"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        counts = prepare_main(["--low-dir", str(low), "--high-dir", str(high), "--out", str(out),
                               "--shape", *map(str, DATA_PATCH), "--val-fraction",
                               str(DATA_VAL_FRACTION), "--seed", "0"])
    prepare_s = time.perf_counter() - t0
    files = sorted(str(p) for p in out.glob("*/*.npz"))
    check(counts == {"train": 6, "val": 2} and len(files) == len(DATA_VOLUMES),
          f"prepare_data wrote {counts}, {len(files)} files")
    t0 = time.perf_counter()
    check(native_loader.available(), "the native NPZ loader did not build")
    build_s = time.perf_counter() - t0
    npz_dataset.load_counts.update(native=0, numpy=0)
    t0 = time.perf_counter()
    native = [npz_dataset.load_pair(f) for f in files]
    native_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    check(npz_dataset.load_counts == {"native": len(files), "numpy": 0},
          f"native loads {npz_dataset.load_counts} of {len(files)} files")
    t0 = time.perf_counter()
    plain = [npz_dataset.load_pair(f, use_native=False) for f in files]
    numpy_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    check(all(np.array_equal(a, b) and a.shape == DATA_PATCH
              for x, y in zip(native, plain) for a, b in zip(x, y)),
          "native pairs differ from the numpy path's")
    batch = native_loader.load_batch(files, DATA_PATCH)
    check(batch is not None and np.array_equal(batch, np.stack([np.stack(p) for p in plain])),
          "native load_batch differs from the numpy path's")
    vols = torch.from_numpy(np.stack([plain[0][0], plain[1][1]])[..., None])
    cpu = scale_intensity_percentiles(vols)
    card = scale_intensity_percentiles(vols.cuda())
    scale_err = (card.cpu() - cpu).abs().max().item()
    check(scale_err <= SCALE_TOL and bool(torch.isfinite(card).all()),
          f"scale_intensity_percentiles on the card differs from the CPU by {scale_err}")
    vols_cuda = vols.cuda()
    return {"counts": counts, "files": len(files), "prepare_s": prepare_s,
            "native_build_s": build_s, "loads": dict(npz_dataset.load_counts),
            "native_load_ms_a_pair": native_ms, "numpy_load_ms_a_pair": numpy_ms,
            "bit_equal": True, "scale_shape": list(vols.shape), "scale_max_abs_err": scale_err,
            "scale_tol": SCALE_TOL,
            "scale_ms": cuda_ms(torch, lambda: scale_intensity_percentiles(vols_cuda), calls=5),
            "train_dir": str(out / "train"), "val_dir": str(out / "val")}


def _model_err(cs, batch: int, patch, remat, measured: int) -> float:
    """The advisor model's allocator part (its peak less the bytes outside
    the allocator) over ``measured``, less one."""
    modeled = cs.estimate_stage1_peak_bytes(batch, patch, remat) - cs._OUTSIDE_ALLOCATOR_BYTES
    return modeled / measured - 1


def _stage1_peaks(torch, ns, gates: list) -> dict:
    """The allocator's peak (``max_memory_reserved`` less what earlier
    phases left reserved) of adversarial bf16 stage-1 steps of ``ns``'s VAE,
    the CLI's discriminator and LPIPS at each point of
    ``check_system.CALIBRATION`` (and under ``--remat convs`` and ``full`` at
    the largest), the model's figure beside each (a gate: within
    MODEL_TOL), the state + bytes-a-voxel fit of these points, and the
    device memory outside the allocator once the steps have run."""
    from ldm3d_torch.cli import check_system as cs
    from ldm3d_torch.cli.train_autoencoder import build_discriminator, build_lpips
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn import init_weights_
    from ldm3d_torch.training import (Stage1Config, TrainState, make_optimizer,
                                      make_stage1_train_step)

    tc = ns.autoencoder_train
    base = _empty_allocator(torch)
    base_allocated = torch.cuda.memory_allocated()
    _reset_counts()
    gen = torch.Generator(device="cuda").manual_seed(17)
    with torch.device("cuda"):
        ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
        disc = init_weights_(build_discriminator(ns), gen)
    ae.compute_dtype = disc.compute_dtype = torch.bfloat16
    lpips = build_lpips(SimpleNamespace(lpips_weights=""), torch.bfloat16, torch.device("cuda"))
    step = make_stage1_train_step(ae, disc, lpips, Stage1Config(
        kl_weight=tc["kl_weight"], perceptual_weight=tc["perceptual_weight"]))
    g_state = TrainState(ae, make_optimizer(ae.parameters(), lambda c: tc["lr"]))
    d_state = TrainState(disc, make_optimizer(disc.parameters(), lambda c: tc["lr"]))
    largest = max(cs.CALIBRATION, key=lambda p: p[0] * math.prod(p[1]))
    points = []
    for (batch, patch), remat in ([(p, None) for p in cs.CALIBRATION]
                                  + [(largest, "convs"), (largest, "full")]):
        ae.remat = remat
        images = torch.rand((batch, *patch, ns.image_channels), generator=gen, device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(CALIBRATION_STEPS):
            metrics = step(g_state, d_state, images, True, gen)
        torch.cuda.synchronize()
        check(all(math.isfinite(float(v)) for v in metrics.values()),
              f"calibration step at batch {batch}, {patch}, remat {remat}: {metrics}")
        peak = torch.cuda.max_memory_reserved() - base
        err = _model_err(cs, batch, patch, remat or False, peak)
        gates.append((abs(err) <= MODEL_TOL,
                      f"calibration at batch {batch}, {patch}, remat {remat}: the advisor's "
                      f"model is {err:+.1%} off the measured allocator peak {peak} B (limit "
                      f"{MODEL_TOL:.0%})"))
        points.append({"batch": batch, "patch": list(patch), "remat": remat or False,
                       "voxels": batch * math.prod(patch), "peak_bytes": peak,
                       "peak_allocated_bytes": torch.cuda.max_memory_allocated() - base_allocated,
                       "model_err_rel": err})
        del images
    ae.remat = None
    outside = _outside_allocator_bytes(torch)
    plain = [p for p in points if not p["remat"]]
    act, state = np.polyfit([p["voxels"] for p in plain], [p["peak_bytes"] for p in plain], 1)
    top = next(p for p in plain if p["voxels"] == largest[0] * math.prod(largest[1]))
    factors = {p["remat"]: (p["peak_bytes"] - state) / (top["peak_bytes"] - state)
               for p in points if p["remat"]}
    del ae, disc, lpips, g_state, d_state, step
    _empty_allocator(torch)
    return {"points": points, "launches": _read_counts(), "earlier_phases_reserved_bytes": base,
            "outside_allocator_bytes": outside,
            "fit": {"state_bytes": float(state), "act_bytes_per_voxel": float(act),
                    "remat_act_factor": factors},
            "model": {"outside_allocator_bytes": cs._OUTSIDE_ALLOCATOR_BYTES,
                      "state_bytes": cs._STAGE1_STATE_BYTES,
                      "act_bytes_per_voxel": cs._STAGE1_ACT_BYTES_PER_VOXEL,
                      "remat_act_factor": {k: cs._REMAT_ACT_FACTOR[k] for k in factors}},
            "max_model_err_rel": max(abs(p["model_err_rel"]) for p in points), "tol": MODEL_TOL,
            "gn_cases": _read_gn_cases(), "attn_cases": _attn_cases()}


def _recipe_run(torch, rec: dict, cfg_path: Path, env: Path, card_bytes: int,
                gates: list, what: str) -> dict:
    """The advisor's stage-1 recipe ``rec`` (written to ``cfg_path``) for a
    card of ``card_bytes``: a copy with warmup_epochs -1, val_interval 1 and
    one epoch through ``cli.train_autoencoder`` with the recipe's flags,
    after the allocator is emptied. Below this card's memory the process's
    allocator is capped (``set_per_process_memory_fraction``) so that what
    it reserves and what it holds outside the allocator fit ``card_bytes``.
    The measured peak (the allocator's peak and the bytes outside it) must
    leave the headroom the recommendation claims, and the model must be
    within MODEL_TOL of the allocator's part (both gates)."""
    from ldm3d_torch.cli import check_system as cs
    from ldm3d_torch.cli.train_autoencoder import main as train_ae_main

    cfg = json.loads(cfg_path.read_text())
    cfg["autoencoder_train"].update(warmup_epochs=-1, val_interval=1, max_epochs=1)
    run_cfg = cfg_path.with_name(f"run_{cfg_path.name}")
    run_cfg.write_text(json.dumps(cfg))
    argv = ["-c", str(run_cfg), "-e", str(env), "--no-images"]
    argv += ["--amp"] if rec["amp"] else []
    argv += [f"--remat={rec['remat']}"] if rec["remat"] else []
    total = torch.cuda.get_device_properties(0).total_memory
    outside = _outside_allocator_bytes(torch)
    base = _empty_allocator(torch)
    cap = None if card_bytes >= total else base + card_bytes - outside
    timings: dict = {}
    _reset_counts()
    unpin_precision(torch)
    if cap is not None:
        torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        best_val = train_ae_main(argv, timings=timings)
    finally:
        if cap is not None:
            torch.cuda.set_per_process_memory_fraction(1.0)
    flags = pinned_precision(torch, f"cli.train_autoencoder.main ({what})")
    allocator_peak = torch.cuda.max_memory_reserved() - base
    outside = max(outside, _outside_allocator_bytes(torch))
    peak = outside + allocator_peak
    steps, val = len(timings["train_step_ms"]), sum(timings["val_batches"])
    check(steps == 3 and val == 1 and all(timings["adv_active"]) and math.isfinite(best_val),
          f"{what}: the recipe ran {steps} steps ({timings['adv_active']}), {val} validation "
          f"batches, val {best_val}")
    batch, patch = rec["batch_size"], rec["patch_size"]
    err = _model_err(cs, batch, patch, rec["remat"], allocator_peak)
    gates.append((peak <= (1 - cs._MIN_HEADROOM) * card_bytes,
                  f"{what}: the measured peak {peak / 2**30:.2f} GiB of "
                  f"{card_bytes / 2**30:.2f} GiB leaves {1 - peak / card_bytes:.1%} free (the "
                  f"recommendation claims at least {cs._MIN_HEADROOM:.0%})"))
    gates.append((abs(err) <= MODEL_TOL,
                  f"{what}: the advisor's model is {err:+.1%} off the recipe's measured "
                  f"allocator peak {allocator_peak} B (limit {MODEL_TOL:.0%})"))
    return {"recommendation": {k: rec[k] for k in ("preset", "batch_size", "patch_size", "amp",
                                                   "remat", "estimated_peak_hbm_gb",
                                                   "hbm_headroom_frac", "data_axis")},
            "card_gib": card_bytes / 2**30, "allocator_cap_gib": cap and cap / 2**30,
            "modeled_peak_gib": rec["estimated_peak_hbm_gb"],
            "measured_peak_gib": peak / 2**30,
            "measured_allocator_peak_gib": allocator_peak / 2**30,
            "measured_outside_allocator_gib": outside / 2**30,
            "earlier_phases_reserved_gib": base / 2**30,
            "measured_headroom": 1 - peak / card_bytes, "model_err_rel": err,
            "train_step_ms": timings["train_step_ms"], "val_ms": timings["val_ms"],
            "allow_tf32": flags}


def _data_advisor(torch, ns, counts, root: Path, data: dict, gates: list) -> dict:
    """``cli.check_system`` on the card, then its recipe (a copy of
    ``config_optimized.json``) for 3 adversarial bf16 steps and one
    validation batch through ``cli.train_autoencoder`` on the prepared data
    (:func:`_recipe_run`); the launches by route, every attention launch at
    DATA_ATTN_SHAPE."""
    from ldm3d_torch.cli import check_system as cs

    cfg_path = root / "config_optimized.json"
    with contextlib.redirect_stdout(io.StringIO()):
        report = cs.main(["--output", str(cfg_path), "--json"])
    rec, dev = report["recommendation"], report["devices"]
    total = torch.cuda.get_device_properties(0).total_memory
    check(dev["platform"] == "gpu" and dev["per_chip_hbm_bytes"] == total,
          f"check_system probed {dev}")
    check((rec["preset"], rec["batch_size"], rec["patch_size"], rec["amp"])
          == ("config_train_32g.json", 2, list(DATA_PATCH), True),
          f"check_system recommends {rec} on a {dev['per_chip_hbm_bytes'] / 2**30:.1f} GiB card")
    model_dir = root / "advisor"
    model_dir.mkdir()
    env = _write_env(model_dir, synthetic_data=False, npz_dir_train=data["train_dir"],
                     npz_dir_val=data["val_dir"], resume_ckpt=False)
    out = _recipe_run(torch, rec, cfg_path, env, total, gates, "the card's recipe")
    steps = len(out["train_step_ms"])
    widths = _attn_routes(torch, ns)
    vae_gn = counts["encoder"]["gn"] + counts["decoder"]["gn"]
    d_gn = counts["discriminator"]["gn"]
    parts = ("encoder", "decoder")
    launched = _check_launches(
        torch, "config_optimized.json", "stage-1 recipe",
        _expected_routes(torch, widths, {p: steps + 1 for p in parts},
                         {p: steps for p in parts}),
        {"gn_sums": vae_gn * (steps + 1) + 3 * d_gn * steps,
         "gn_bwd_sums": vae_gn * steps + 3 * d_gn * steps})
    attn = _attn_cases()
    check(set(attn["fwd"]) == set(attn["bwd"]) == {(DATA_ATTN_SHAPE, "bfloat16")},
          f"the recipe's attention ran at {attn}, not only at {DATA_ATTN_SHAPE}")
    shutil.rmtree(model_dir)
    return {**out, "launch_command": report["launch_command"],
            "attention_shape": list(DATA_ATTN_SHAPE), **launched, "config_path": str(cfg_path),
            "gn_cases": _read_gn_cases(), "attn_cases": attn}


def _data_advisor_small(torch, root: Path, gates: list) -> dict:
    """The advisor's recommendation for a SMALL_CARD_BYTES card (this card's
    probe with that memory), run for 3 steps of its batch and patch on
    synthetic volumes of the patch's size under an allocator cap that leaves
    the process that card's memory (:func:`_recipe_run`)."""
    from ldm3d_torch.cli import check_system as cs

    dev = {**cs.probe_devices(), "per_chip_hbm_bytes": SMALL_CARD_BYTES}
    rec = cs.recommend_settings(dev, cs.probe_host())
    check((rec["preset"], rec["batch_size"], rec["patch_size"], rec["amp"])
          == ("config_train_32g.json", 8, [64, 64, 64], True),
          f"check_system recommends {rec} for a {SMALL_CARD_BYTES / 2**30:.0f} GiB card")
    cfg_path = root / "config_small_card.json"
    cs.generate_config_file(rec, str(cfg_path))
    model_dir = root / "advisor_small"
    model_dir.mkdir()
    env = _write_env(model_dir, synthetic_num=_pairs_for_steps(rec["batch_size"]),
                     synthetic_shape=rec["patch_size"], resume_ckpt=False)
    out = _recipe_run(torch, rec, cfg_path, env, SMALL_CARD_BYTES, gates,
                      f"the {SMALL_CARD_BYTES / 2**30:.0f} GiB card's recipe")
    launches = _read_counts()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gn_sums", "gn_bwd_sums"):
        check(launches[kernel] > 0, f"the small card's recipe launched no {kernel}")
    shutil.rmtree(model_dir)
    return {**out, "launch_command": cs.generate_launch_command(rec), "launches": launches,
            "gn_cases": _read_gn_cases(), "attn_cases": _attn_cases()}


def _data_pipeline(torch, root: Path, data: dict, cfg_path: str) -> dict:
    """``TrainingPipeline.run_local`` over the prepared data with the
    advisor's ``config_optimized.json``, one epoch a stage (3 steps each),
    bf16: data check, stage 1, stage 2, the evaluation CLI (DDIM-8 over the 2
    validation pairs: the sampled path, whose result carries ``ssim``) and
    the registry (threshold 0, so that the version registers)."""
    from ldm3d_torch.mlops.pipelines import TrainingPipeline
    from ldm3d_torch.mlops.tracking import ModelRegistry

    model_dir = root / "pipeline"
    model_dir.mkdir()
    env = _write_env(model_dir, synthetic_data=False, npz_dir_train=data["train_dir"],
                     npz_dir_val=data["val_dir"], resume_ckpt=False)
    registry = ModelRegistry(str(root / "registry"))
    pipe = TrainingPipeline(cfg_path, str(env), str(model_dir), eval_threshold=0.0,
                            registry=registry, max_epochs=1, extra_flags=["--amp", "--no-images"])
    _reset_counts()
    unpin_precision(torch)
    results = pipe.run_local()
    flags = pinned_precision(torch, "TrainingPipeline.run_local")
    launches = _read_counts()
    ev = results["evaluation"]
    check(results["data_prep"] == {"train_samples": 6, "val_samples": 2},
          f"pipeline data check {results['data_prep']}")
    check("ssim" in ev and all(math.isfinite(ev[k]) for k in ("score", "ssim", "psnr")),
          f"the pipeline's evaluation took the loss proxy or gave non-finite metrics: {ev}")
    check(results["registered_version"] == 1, f"registered {results['registered_version']}")
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gn_sums", "gn_bwd_sums"):
        check(launches[kernel] > 0, f"the pipeline launched no {kernel}")
    shutil.rmtree(model_dir)
    return {"results": {k: v for k, v in results.items() if k != "registered_version"},
            "registered_version": results["registered_version"], "launches": launches,
            "allow_tf32": flags, "gn_cases": _read_gn_cases(), "attn_cases": _attn_cases()}


def _data_attention_checks(torch, F, runs: dict, checked: tuple) -> tuple[dict, dict]:
    """The forward and backward kernels held to their plain versions (TF32
    off) and timed at every attention input the phase's runs gave them
    (``_fwd_case``/``_bwd_case``), but for the (shape, dtype) pairs in
    ``checked`` (those the kernel phases hold, in the whole script); each
    row carries the runs' launches at it."""
    from ldm3d_torch.cli.common import tf32_flags

    gen = torch.Generator(device="cuda").manual_seed(18)
    out: tuple[dict, dict] = ({}, {})
    with tf32_flags(False):
        for i, (kind, case) in enumerate((("fwd", _fwd_case), ("bwd", _bwd_case))):
            keys = sorted({k for r in runs.values() for k in r["attn_cases"][kind]}, key=str)
            for shape, dtype in keys:
                if (shape, dtype) in checked[i]:
                    continue
                out[i][(shape, dtype)] = case(
                    torch, F, dtype, shape, gen, phase=f"data_tools_kernel_{kind}")
                emit({"phase": f"data_tools_kernel_{kind}_launches", "shape_bnhd": list(shape),
                      "dtype": dtype, "launches": {name: r["attn_cases"][kind].get(
                          (shape, dtype), 0) for name, r in runs.items()}})
    return out


def phase_data_tools(torch, F, ns, counts, workdir: Path, card: str, smi_line: str,
                     checked: tuple = (set(), set())) -> dict:
    """16. The data tools, the system advisor and the training pipeline on
    the card (see the module docstring); one line a part, then the phase's.
    The memory gates are read at the end, after every part has run and
    printed its readings."""
    t0 = time.perf_counter()
    root = workdir / "data_tools"
    out: dict = {}
    gates: list = []
    parts = (("prepare", lambda: _data_prepare(torch, root)),
             ("calibration", lambda: _stage1_peaks(torch, ns, gates)),
             ("advisor", lambda: _data_advisor(torch, ns, counts, root, out["prepare"], gates)),
             ("advisor_small", lambda: _data_advisor_small(torch, root, gates)),
             ("pipeline", lambda: _data_pipeline(torch, root, out["prepare"],
                                                 out["advisor"]["config_path"])))
    for part, run in parts:
        t = time.perf_counter()
        out[part] = run()
        out[part]["seconds"] = time.perf_counter() - t
        emit({"phase": f"data_tools_{part}", "card": card, "nvidia_smi": smi_line,
              **{k: v for k, v in out[part].items() if k not in ("gn_cases", "attn_cases")}})
    runs = {part: r for part, r in out.items() if "attn_cases" in r}
    t = time.perf_counter()
    fwd, bwd = _data_attention_checks(torch, F, runs, checked)
    shutil.rmtree(root)
    emit({"phase": "data_tools", "card": card, "nvidia_smi": smi_line,
          "seconds": time.perf_counter() - t0, "kernel_checks_s": time.perf_counter() - t,
          **{part: r["seconds"] for part, r in out.items()},
          "gates": [{"ok": ok, "what": msg} for ok, msg in gates]})
    for ok, msg in gates:
        check(ok, msg)
    return {**{f"{part}_launches": r["launches"] for part, r in runs.items()},
            "fwd": fwd[(DATA_ATTN_SHAPE, "bfloat16")], "bwd": bwd[(DATA_ATTN_SHAPE, "bfloat16")],
            "gn_paths": {f"data_tools_{part}": r["gn_cases"] for part, r in runs.items()}}


def _kernel_summary(fwd: dict, bwd: dict, gn: dict, sample_launches: dict,
                    train: dict, train_fp32: dict, serve: dict, conv: dict,
                    train_ae: dict, train_ae_fp32: dict, distill: dict,
                    presets: dict, follow_ups: dict, data_tools: dict,
                    parallel: dict) -> list:
    """The kernels line: each kernel's ms, plain_ms, bound_ms and library_ms
    are summed over the ``launches`` it counts (one flagship sample for
    flash_fwd, the bf16 training main path's run for the other four; the
    GroupNorm kernels also over the sample, as ``sample_*``); the served
    launches of flash_fwd and gn_sums are ``serve_launches``; the backward
    kernels' ``fp32_*`` fields are one step of the fp32 training run.
    The stage-1 runs' launches are ``train_ae_launches`` (bf16) and
    ``train_ae_fp32_launches``; the attention kernels' ``train_ae_step_*``
    (and ``train_ae_fp32_step_*``) are one stage-1 step's launches at
    AE_TRAIN_SHAPE, the GroupNorm kernels' ``train_ae_*`` the sums over the
    bf16 stage-1 run's launches (``train_ae_fp32_*`` the fp32 run's).
    conv3d_igemm's launches are the A/B tool's run; its times are per call
    at the tool's headline shape. ``presets_launches`` are each presets-phase
    run's launches (the forward's wgmma row: its route's);
    ``remat_launches_per_step`` are the follow_ups phase's stage-2 (32g and
    pp) and stage-1 steps' launches under each remat mode;
    ``data_tools_launches`` the data_tools phase's runs' (the calibration
    steps, the card's stage-1 recipe, every attention launch at
    DATA_ATTN_SHAPE, the small card's recipe and the pipeline's run), and the
    attention rows' ``data_tools_*`` one call at DATA_ATTN_SHAPE, bf16;
    ``parallel_launches`` the parallel phase's bf16 data-parallel run (both
    ranks' warm-up and timed steps), ``parallel_spatial_launches`` its bf16
    spatial run's (both ranks' two steps)."""
    def per(results, weights, key, by=None, dtype="bfloat16"):
        return sum(n * results[(shape, dtype)][key] for shape, n in weights.items()
                   if by is None or results[(shape, dtype)].get("bound_by", by) == by)

    steps = train["steps"]

    def per_bwd(key, by_key=None, by=None, dtype="bfloat16"):
        """Summed over one training step's launches."""
        return sum(n * bwd[(shape, dtype)][key] for shape, n in TRAIN_BWD_PER_STEP.items()
                   if by is None or bwd[(shape, dtype)][by_key] == by)

    def larger(fn):
        return max(("operations", "bytes"), key=fn)

    ae_attn = train_ae["launches_per_step"]["warmup"]["flash_fwd"]

    def ae_attention(results, keys, prefix):
        """One stage-1 step's ``ae_attn`` launches at AE_TRAIN_SHAPE, both dtypes."""
        out = {}
        for dtype, tag in (("bfloat16", "train_ae_step"), ("float32", "train_ae_fp32_step")):
            r = results[(AE_TRAIN_SHAPE, dtype)]
            for key, name in keys:
                out[f"{tag}_{name}"] = ae_attn * r[f"{prefix}{key}"]
        return out

    run_note = (f"the training main path's run ({steps} steps of batch 20 at 80^3, "
                f"{train['val_batches']} validation batch, the scale-factor encode; bf16): the "
                "sum over its launches")
    bwd_err = {kind: max(max(r["max_abs_err"][k] for k in keys) for r in bwd.values())
               for kind, keys in (("dq", ("dq",)), ("dkv", ("dk", "dv")))}
    bwd_ratio = {kind: max(max(r["max_abs_err"][k] / r["tol"][k] for k in keys)
                           for r in bwd.values())
                 for kind, keys in (("dq", ("dq",)), ("dkv", ("dk", "dv")))}
    sdpa = per_bwd("sdpa_bwd_ms")

    def flash_bwd(name, kind, replaces, library_covers):
        for run in (train, train_fp32):
            check(run["launches"][name] == run["steps"] * sum(TRAIN_BWD_PER_STEP.values()),
                  f"{name} launches {run['launches'][name]} are not {run['steps']} steps' worth")
        check(train["launches"][f"{name}_wgmma"] == train["launches"][name],
              f"{name}: {train['launches'][f'{name}_wgmma']} of {train['launches'][name]} bf16 "
              "training launches on the wgmma route")
        row = {"name": name, "route": "cuda", "source": "ldm3d_torch/csrc/flash_bwd.cu",
               "routes": BWD_ROUTES, "replaces": replaces, "launches": train["launches"][name],
               "max_abs_err": bwd_err[kind], "max_err_over_tol": bwd_ratio[kind],
               "ms": steps * per_bwd(f"{kind}_ms"),
               "plain_ms": steps * per_bwd(f"{kind}_plain_ms"),
               "bound_ms": steps * per_bwd(f"{kind}_bound_ms"),
               "bound_by": larger(lambda by: per_bwd(f"{kind}_bound_ms", f"{kind}_bound_by", by)),
               "library_ms": steps * sdpa, "library_covers": library_covers,
               "host_ms": steps * per_bwd(f"{kind}_host_ms"), "per": run_note,
               "ms_per_step": per_bwd(f"{kind}_ms"),
               "wgmma_launches": train["launches"][f"{name}_wgmma"],
               "fp32_launches": train_fp32["launches"][name],
               "fp32_launches_per_step": sum(TRAIN_BWD_PER_STEP.values()),
               "fp32_library_ms": per_bwd("sdpa_bwd_ms", dtype="float32"),
               "fp32_per": "one step of the fp32 training run (no --amp): the sum over its "
                           "launches at the two UNet shapes"}
        for key in ("ms", "plain_ms", "bound_ms", "host_ms"):
            row[f"fp32_{key}"] = per_bwd(f"{kind}_{key}", dtype="float32")
        for run, tag, route in ((train_ae, "train_ae", "mma"), (train_ae_fp32, "train_ae_fp32",
                                                                "fp32")):
            check(run["launches"][f"{name}_{route}"] == run["launches"][name]
                  == ae_attn * run["steps"],
                  f"{name}: stage-1 launches {run['launches']} are not {run['steps']} steps' "
                  f"worth on the {route} route")
            row[f"{tag}_launches"] = run["launches"][name]
        row.update(ae_attention(bwd, (("_ms", "ms"), ("_plain_ms", "plain_ms"),
                                      ("_bound_ms", "bound_ms")), kind))
        for dtype, tag in (("bfloat16", "train_ae_step"), ("float32", "train_ae_fp32_step")):
            row[f"{tag}_library_ms"] = ae_attn * bwd[(AE_TRAIN_SHAPE, dtype)]["sdpa_bwd_ms"]
        row["train_ae_per"] = (f"one stage-1 step's {ae_attn} launches at {AE_TRAIN_SHAPE} "
                               "(the VAE's d = 256 attention at the 64^3 patch; bf16 on the "
                               "mma.sync route, fp32 on 3xTF32); library: SDPA's whole backward")
        return row

    def gn_row(name, replaces, library_note):
        tr = gn["totals"][("training", name)]
        check(tr["launches"] == train["launches"][name],
              f"{name}: recorded inputs cover {tr['launches']} of {train['launches'][name]} "
              f"training launches")
        row = {"name": name, "route": "cuda", "source": "ldm3d_torch/csrc/groupnorm_sums.cu",
               "replaces": replaces, "launches": tr["launches"],
               "max_abs_err": gn["max_abs_err"][name], "ms": tr["ms"], "plain_ms": tr["plain_ms"],
               "bound_ms": tr["bound_ms"], "bound_by": "bytes",
               "library_ms": tr.get("library_ms"), "library_note": library_note,
               "host_ms": tr["host_ms"], "per": run_note}
        if "library_ncdhw_ms" in tr:
            row["library_ncdhw_ms"] = tr["library_ncdhw_ms"]
        if "var_mean_ms" in tr:  # B4's yardstick: one call, the same statistics
            row["var_mean_ms"] = row["library_ms"] = tr["var_mean_ms"]
        se = gn["totals"].get(("serving", name))
        if se is not None:
            check(se["launches"] == serve["launches"][name],
                  f"{name}: recorded inputs cover {se['launches']} of "
                  f"{serve['launches'][name]} serving launches")
            row.update(serve_launches=se["launches"], serve_ms=se["ms"],
                       serve_plain_ms=se["plain_ms"], serve_bound_ms=se["bound_ms"],
                       serve_host_ms=se["host_ms"])
        for path, tag in (("training_ae", "train_ae"), ("training_ae_fp32", "train_ae_fp32")):
            ae = gn["totals"][(path, name)]
            run = train_ae if path == "training_ae" else train_ae_fp32
            check(ae["launches"] == run["launches"][name],
                  f"{name}: recorded inputs cover {ae['launches']} of {run['launches'][name]} "
                  f"{path} launches")
            row.update({f"{tag}_launches": ae["launches"], f"{tag}_ms": ae["ms"],
                        f"{tag}_plain_ms": ae["plain_ms"], f"{tag}_bound_ms": ae["bound_ms"],
                        f"{tag}_host_ms": ae["host_ms"]})
            row.update({f"{tag}_{k}": ae[k] for k in ("library_ms", "library_ncdhw_ms")
                        if k in ae})
        sa = gn["totals"].get(("sampling", name))
        if sa is not None:
            check(sa["launches"] == sample_launches[name],
                  f"{name}: recorded inputs cover {sa['launches']} of {sample_launches[name]} "
                  f"sampling launches")
            row.update(sample_launches=sa["launches"], sample_ms=sa["ms"],
                       sample_plain_ms=sa["plain_ms"], sample_bound_ms=sa["bound_ms"],
                       sample_host_ms=sa["host_ms"], sample_var_mean_ms=sa["var_mean_ms"])
        return row

    head = {r["dtype"]: r for r in conv["records"] if tuple(r["shape"]) == (8, 96, 96, 96, 64)}
    conv_row = {"name": "conv3d_igemm", "route": "cuda",
                "source": "ldm3d_torch/csrc/conv3d_igemm.cu", "routes": CONV_ROUTES,
                "replaces": "ldm3d_tpu/ops/conv3d.py:58", "launches": conv["launches"],
                "max_abs_err": max(r["max_abs_err"] for r in conv["records"]),
                "max_rel_err_over_tol": max(r["rel_err"] / r["rel_tol"] for r in conv["records"]),
                "ms": head["bfloat16"]["kernel_ms"], "plain_ms": head["bfloat16"]["plain_ms"],
                "bound_ms": head["bfloat16"]["bound_ms"], "bound_by": head["bfloat16"]["bound_by"],
                "library_ms": head["bfloat16"]["library_ms"],
                "host_ms": head["bfloat16"]["host_ms"],
                "library_covers": "F.conv3d (cuDNN) on channels_last_3d, bf16",
                "fp32_ms": head["float32"]["kernel_ms"], "fp32_plain_ms": head["float32"]["plain_ms"],
                "fp32_bound_ms": head["float32"]["bound_ms"],
                "fp32_library_ms": head["float32"]["library_ms"],
                "per": "one call at (8, 96, 96, 96, 64), bf16 (fp32_*: fp32, cuDNN with TF32 "
                       "off); launches: the A/B tool's whole run (checks and timing loops at "
                       "every shape and dtype)"}
    wg_rows = {s: r for (s, dt), r in fwd.items() if dt == "bfloat16"
               and fwd_route(dt, s[3]) == "bf16_wgmma"}
    wg_sample = {MAIN_SHAPES[2]: LAUNCHES_PER_SAMPLE[MAIN_SHAPES[2]]}
    wg_step = {TRAIN_SHAPES[2]: TRAIN_FWD_PER_STEP[TRAIN_SHAPES[2]]}
    wgmma_row = {
        "name": "flash_fwd_bf16_wgmma", "route": "cuda", "source": "ldm3d_torch/csrc/flash_fwd.cu",
        "kernel": "flash_fwd_bf16_wgmma_kernel", "route_detail": FWD_ROUTES["bf16_wgmma"],
        "replaces": "ldm3d_tpu/ops/attention.py:49 and ldm3d_tpu/ops/attention.py:83",
        "launches": sample_launches["flash_fwd_wgmma"],
        "max_abs_err": max(r["max_abs_err"] for r in wg_rows.values()),
        "lse_max_abs_err": max(r["lse_max_abs_err"] for r in wg_rows.values()),
        "ms": per(fwd, wg_sample, "kernel_ms"), "plain_ms": per(fwd, wg_sample, "plain_ms"),
        "bound_ms": per(fwd, wg_sample, "bound_ms"),
        "bound_by": fwd[(MAIN_SHAPES[2], "bfloat16")]["bound_by"],
        "library_ms": per(fwd, wg_sample, "library_ms"),
        "host_ms": per(fwd, wg_sample, "kernel_host_ms"),
        "per": "one flagship sample: its 4 launches at (1, 8000, 1, 256), bf16 (the VAE's "
               "encoder and decoder attention); train_*: one bf16 training step's 4 launches "
               "at (20, 8000, 1, 256)",
        "train_launches": train["launches"]["flash_fwd_wgmma"],
        "train_ae_launches": train_ae["launches"]["flash_fwd_wgmma"],
        "train_step_ms": per(fwd, wg_step, "kernel_ms"),
        "train_step_plain_ms": per(fwd, wg_step, "plain_ms"),
        "train_step_bound_ms": per(fwd, wg_step, "bound_ms"),
        "train_step_library_ms": per(fwd, wg_step, "library_ms"),
    }
    rows = [
        {"name": "flash_fwd", "route": "cuda", "source": "ldm3d_torch/csrc/flash_fwd.cu",
         "routes": FWD_ROUTES,
         "replaces": "ldm3d_tpu/ops/attention.py:49 and ldm3d_tpu/ops/attention.py:83",
         "launches": sample_launches["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in fwd.values()),
         "ms": per(fwd, LAUNCHES_PER_SAMPLE, "kernel_ms"),
         "plain_ms": per(fwd, LAUNCHES_PER_SAMPLE, "plain_ms"),
         "bound_ms": per(fwd, LAUNCHES_PER_SAMPLE, "bound_ms"),
         "bound_by": larger(lambda by: per(fwd, LAUNCHES_PER_SAMPLE, "bound_ms", by)),
         "library_ms": per(fwd, LAUNCHES_PER_SAMPLE, "library_ms"),
         "host_ms": per(fwd, LAUNCHES_PER_SAMPLE, "kernel_host_ms"),
         "per": "one flagship sample (80^3, batch 1, DDIM-50, bf16): the sum over its "
                "554 launches at the three main-path shapes",
         "train_launches": train["launches"]["flash_fwd"],
         "train_step_ms": per(fwd, TRAIN_FWD_PER_STEP, "kernel_ms"),
         "train_step_plain_ms": per(fwd, TRAIN_FWD_PER_STEP, "plain_ms"),
         "train_step_bound_ms": per(fwd, TRAIN_FWD_PER_STEP, "bound_ms"),
         "train_step_library_ms": per(fwd, TRAIN_FWD_PER_STEP, "library_ms"),
         "train_fp32_launches": train_fp32["launches"]["flash_fwd"],
         "train_fp32_step_ms": per(fwd, TRAIN_FWD_PER_STEP, "kernel_ms", dtype="float32"),
         "train_fp32_step_plain_ms": per(fwd, TRAIN_FWD_PER_STEP, "plain_ms", dtype="float32"),
         "train_fp32_step_bound_ms": per(fwd, TRAIN_FWD_PER_STEP, "bound_ms", dtype="float32"),
         "train_fp32_step_library_ms": per(fwd, TRAIN_FWD_PER_STEP, "library_ms",
                                           dtype="float32"),
         "serve_call_fp32_ms": per(fwd, SERVE_FWD_PER_CALL, "kernel_ms", dtype="float32"),
         "serve_call_fp32_plain_ms": per(fwd, SERVE_FWD_PER_CALL, "plain_ms", dtype="float32"),
         "serve_call_fp32_bound_ms": per(fwd, SERVE_FWD_PER_CALL, "bound_ms", dtype="float32"),
         "serve_call_fp32_library_ms": per(fwd, SERVE_FWD_PER_CALL, "library_ms",
                                           dtype="float32"),
         "serve_call_note": "fp32, one merged batch-2 DDIM-50 serving call: the sum over its "
                            "556 launches (SERVE_FWD_PER_CALL)",
         "train_ae_launches": train_ae["launches"]["flash_fwd"],
         "train_ae_fp32_launches": train_ae_fp32["launches"]["flash_fwd"],
         **ae_attention(fwd, (("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
                              ("bound_ms", "bound_ms"), ("library_ms", "library_ms")), ""),
         "train_ae_per": f"one stage-1 step's {ae_attn} launches at {AE_TRAIN_SHAPE} (bf16 on "
                         "the wgmma route, fp32 on 3xTF32); each validation batch adds "
                         f"{ae_attn} at {MAIN_SHAPES[2]}"},
        flash_bwd("flash_bwd_dq", "dq", "ldm3d_tpu/ops/attention.py:122",
                  "dQ, dK and dV together: the backward of scaled_dot_product_attention (its "
                  "forward + backward less its forward)"),
        flash_bwd("flash_bwd_dkv", "dkv", "ldm3d_tpu/ops/attention.py:150",
                  "dQ, dK and dV together (as flash_bwd_dq's)"),
        gn_row("gn_sums", "ldm3d_tpu/ops/groupnorm.py:70",
               "torch.var_mean over the spatial dims (Welford mean and variance per (batch, "
               "channel), the statistics the sum and the sum of squares give) is library_ms "
               "(also var_mean_ms)"),
        gn_row("gn_bwd_sums", "ldm3d_tpu/ops/groupnorm.py:144",
               "torch.ops.aten.native_group_norm_backward(..., [False, True, True]) on dy and "
               "x viewed as one sample of batch * channels, one group a channel, returns both "
               "per-(batch, channel) sums: library_ms and *_library_ms time it over each "
               "run's launches with the NCDHW copies that view needs, *_library_ncdhw_ms on "
               "premade NCDHW copies"),
        conv_row,
    ]
    rows.insert(1, wgmma_row)
    rows[0]["serve_launches"] = serve["launches"]["flash_fwd"]
    for row in rows:
        key = {"flash_fwd_bf16_wgmma": "flash_fwd_wgmma"}.get(row["name"], row["name"])
        for run, r in distill["runs"].items():
            row[f"distill_{run}_launches"] = r["launches"][key]
            row[f"distill_{run}_launches_per_step"] = r["launches_per_step"][key]
        row["presets_launches"] = {run: r[key] for run, r in presets.items()}
        row["remat_launches_per_step"] = {
            run: {mode: c[key] for mode, c in modes.items()}
            for run, modes in follow_ups["launches_per_step"].items()}
        row["data_tools_launches"] = {run.removesuffix("_launches"): r[key]
                                      for run, r in data_tools.items()
                                      if run.endswith("_launches")}
        row["parallel_launches"] = parallel["launches"][key]
        row["parallel_spatial_launches"] = parallel["spatial_launches"][key]
    shape = {"data_tools_shape": list(DATA_ATTN_SHAPE)}
    fwd_dt, bwd_dt = data_tools["fwd"], data_tools["bwd"]
    for row in rows:
        kind = {"flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}.get(row["name"])
        if row["name"] in ("flash_fwd", "flash_fwd_bf16_wgmma"):
            row.update(shape, data_tools_ms=fwd_dt["kernel_ms"],
                       data_tools_plain_ms=fwd_dt["plain_ms"],
                       data_tools_bound_ms=fwd_dt["bound_ms"],
                       data_tools_library_ms=fwd_dt["library_ms"])
        if kind:
            row.update(shape, data_tools_ms=bwd_dt[f"{kind}_ms"],
                       data_tools_plain_ms=bwd_dt[f"{kind}_plain_ms"],
                       data_tools_bound_ms=bwd_dt[f"{kind}_bound_ms"],
                       data_tools_library_ms=bwd_dt["sdpa_bwd_ms"])
    return rows


# --- phase 17: data parallelism --------------------------------------------------

PARALLEL_PRESET = "config_train_32g.json"
# the gradients of N ranks against one process on the same global batch: the
# limit --grad-accum's check uses (PERF.md section 2); a faulty program's
# gradients must read at least 100 times it
PARALLEL_GRAD_TOL = 5e-5
PARALLEL_FAULT_FLOOR = 100 * PARALLEL_GRAD_TOL
PARALLEL_SAMPLE_TOL = 1e-3  # the batch-independence limit of a sample (fp32)
# one step's updates, over the plain step's largest |update| (about lr): the
# limit sits between the sound readings and that of a ZeRO-1 whose ranks
# never rejoin their slices (PERF.md section 2)
PARALLEL_ZERO_TOL = 1e-2
PARALLEL_ZERO_FAULT_FLOOR = 0.5
PARALLEL_TIMED_STEPS = 3
PATH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gn_sums", "gn_bwd_sums")
# depth sharding: a preset whose patch depth 2 * 2^(its downsamples) divides
SPATIAL_PRESET = "config_train_multigpu.json"
SPATIAL_FAULTS = ("skip_spatial_sum",)


def phase_parallel(torch, ns, workdir: Path, card: str, smi_line: str) -> dict:
    """17. Data parallelism (see the module docstring); one line a part, then
    the phase's line. Returns the launches of the bf16 data-parallel run
    (both ranks' warm-up and timed steps)."""
    import torch.nn.functional as F

    from ldm3d_torch.cli.inference import main as infer_main
    from ldm3d_torch.parallel.launch import RankPool, group_of_one
    sys.path.append(str(ROOT / "tools"))
    import dp_check as D
    from ldm3d_torch.configs import load_json, preset_path
    from ldm3d_torch.utils.nifti import read_nifti

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    label = ("two ranks time-sharing one card over gloo (not a multi-card figure)")
    out: dict = {}
    zero = None

    def part(name, record):
        out[name] = record
        emit({"phase": f"parallel_{name}", "card": card, "nvidia_smi": smi_line, **record})

    with RankPool(2, devices=["cuda:0", "cuda:0"], backend="gloo", timeout_s=600) as pool:
        t = time.perf_counter()
        for stage, batch in ((2, TRAIN_BATCH), (1, 2)):
            res = pool.run(D.grads_check, PARALLEL_PRESET, stage, batch, zero=stage == 2)
            worst = {run: max(r[run] for r in res) for run in res[0] if run != "seconds"}
            if stage == 2:
                zero = {k: worst.pop(k) for k in ("held_share", "repeat", "zero",
                                                  "zero_no_gather")}
            part(f"stage{stage}_grads", {
                "global_batch": batch, "per_rank_batch": batch // 2, "dtype": "float32",
                "grad_err_over_max_g": worst, "tol": PARALLEL_GRAD_TOL,
                "fault_floor": PARALLEL_FAULT_FLOOR, "seconds": time.perf_counter() - t,
                "rank0_seconds": res[0]["seconds"],
                **({"zero_update_err_over_max_update": zero, "zero_tol": PARALLEL_ZERO_TOL,
                    "zero_fault_floor": PARALLEL_ZERO_FAULT_FLOOR} if stage == 2 else {})})
            t = time.perf_counter()

        t = time.perf_counter()
        model_dir, _ = _flagship_checkpoints(torch, ns, workdir)
        env = _write_env(model_dir, synthetic_num=4, val_fraction=0.5)
        argv = ["-c", str(ROOT / "ldm3d_torch/configs/presets" / PARALLEL_PRESET), "-e",
                str(env), "--batch", "2", "--sampler", "ddim", "--steps", "10"]
        two = pool.run(D.cli, "inference", argv + ["-g", "2"])[0]
        gc.collect()
        torch.cuda.empty_cache()
        one = infer_main(argv)
        sample_err = max(float(abs(read_nifti(a)[0] - read_nifti(b)[0]).max())
                         for a, b in zip(sorted(two), sorted(one)))
        shutil.rmtree(model_dir)
        part("sampling", {"sampler": "ddim", "steps": 10, "global_batch": 2, "dtype": "float32",
                          "volumes": len(two), "max_abs_err": sample_err,
                          "tol": PARALLEL_SAMPLE_TOL, "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        timed = pool.run(D.timed_steps, PARALLEL_PRESET, TRAIN_BATCH, PARALLEL_TIMED_STEPS)
        per_rank = [_counts_by_key(r["step_counts"]) for r in timed]
        one_step = _counts_by_key(timed[0]["one_process_counts"])
        run_counts = {k: sum(_counts_by_key(r["step_counts"])[k]
                             + _counts_by_key(r["timed_counts"])[k] for r in timed)
                      for k in one_step}
        part("bf16_steps", {
            "global_batch": TRAIN_BATCH, "per_rank_batch": TRAIN_BATCH // 2, "dtype": "bfloat16",
            "steps_timed": PARALLEL_TIMED_STEPS,
            "ms_per_step": [r["ms_per_step"] for r in timed], "timing_is": label,
            "launches_per_rank_step": per_rank, "one_process_launches_per_step": one_step,
            "run_launches": run_counts, "peak_gib_per_rank": [r["peak_gib"] for r in timed],
            "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        sp = pool.run(D.spatial_check, SPATIAL_PRESET)
        steps_s = time.perf_counter() - t
        model_dir, _ = _flagship_checkpoints(
            torch, SimpleNamespace(**load_json(preset_path(SPATIAL_PRESET))), workdir)
        env = _write_env(model_dir, synthetic_num=4, val_fraction=0.5)
        argv = ["-c", preset_path(SPATIAL_PRESET), "-e", str(env), "--batch", "1",
                "--sampler", "ddim", "--steps", "10"]
        sp_cli = pool.run(D.cli_cases, "inference", argv + ["-g", "2", "--spatial", "2"])
        sp[0]["cases"]["cli_inference"] = sp_cli[0]["cases"]
        # read now: the one-process run writes into the same folder
        two_sp = [read_nifti(f)[0] for f in sorted(sp_cli[0]["out"])]
        gc.collect()
        torch.cuda.empty_cache()
        one_sp = infer_main(argv)
        sp_sample_err = max(float(abs(a - read_nifti(b)[0]).max())
                            for a, b in zip(two_sp, sorted(one_sp)))
        shutil.rmtree(model_dir)
        sp_per_rank = [_counts_by_key(r["step_counts"]) for r in sp]
        sp_one = _counts_by_key(sp[0]["one_process_counts"])
        sp_cli_counts = [_counts_by_key(r["counts"]) for r in sp_cli]
        sp_counts = {k: sum(_counts_by_key(r["step_counts"])[k]
                            + _counts_by_key(r["timed_counts"])[k] for r in sp)
                     + sum(c[k] for c in sp_cli_counts) for k in sp_one}
        part("spatial", {
            "preset": SPATIAL_PRESET, "ranks": "1 data x 2 spatial", "global_batch": 2,
            "grad_err_over_max_g": {k: max(r[k] for r in sp)
                                    for k in ("spatial", *SPATIAL_FAULTS)},
            "grad_dtype": "float32", "tol": PARALLEL_GRAD_TOL,
            "fault_floor": PARALLEL_FAULT_FLOOR,
            "sample": "cli.inference -g 2 --spatial 2, ddim-10 fp32, --batch 1",
            "sample_max_abs_err": sp_sample_err, "sample_tol": PARALLEL_SAMPLE_TOL,
            "sample_shape": [list(v.shape) for v in two_sp],
            "sample_finite": all(bool(np.isfinite(v).all()) for v in two_sp),
            "cli_volumes_written": [len(r["out"]) for r in sp_cli],
            "cli_launches_per_rank": sp_cli_counts,
            "bf16_ms_per_step": [r["ms_per_step"] for r in sp],
            "timing_is": label, "launches_per_rank_step": sp_per_rank,
            "one_process_launches_per_step": sp_one, "run_launches": sp_counts,
            "transfers_first_bf16_step": [r["transfers"] for r in sp],
            "peak_gib_per_rank": [r["peak_gib"] for r in sp],
            "rank_seconds": [r["seconds"] for r in sp], "steps_seconds": steps_s,
            "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sp_attn = _spatial_attention_checks(torch, F, sp)
    out["spatial_kernels"] = {"cases_fwd": len(sp_attn[0]), "cases_bwd": len(sp_attn[1]),
                              "seconds": time.perf_counter() - t}

    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with group_of_one("nccl"):  # this process alone, over NCCL
        fsdp = D.fsdp_world1(PARALLEL_PRESET, 2, str(workdir / "fsdp1"))
    shutil.rmtree(workdir / "fsdp1", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_plain, fsdp_sharded = (_counts_by_key(fsdp[k]) for k in ("plain_counts", "fsdp_counts"))
    part("fsdp_world1", {"backend": "nccl", "batch": 2, "dtype": "bfloat16",
                         "launches_unwrapped": fsdp_plain, "launches_fully_shard": fsdp_sharded,
                         "sharded_params": fsdp["sharded_params"], "loss": fsdp["loss"],
                         "checkpoint_bit_equal": fsdp["checkpoint_bit_equal"],
                         "parts_seconds": fsdp["seconds"], "seconds": time.perf_counter() - t})

    # the gates, read once every part has printed
    for stage in (2, 1):
        errs = out[f"stage{stage}_grads"]["grad_err_over_max_g"]
        check(errs["ddp"] <= PARALLEL_GRAD_TOL,
              f"stage {stage}: 2 ranks' gradients {errs['ddp']:.3g} of max |g| from one "
              f"process's (limit {PARALLEL_GRAD_TOL})")
        for fault in D.FAULTS:
            check(errs[fault] >= PARALLEL_FAULT_FLOOR,
                  f"stage {stage}: the fault {fault} reads {errs[fault]:.3g}, under "
                  f"{PARALLEL_FAULT_FLOOR}: the check cannot see it")
    check(zero is not None and zero["zero"] <= PARALLEL_ZERO_TOL,
          f"ZeRO-1's update {zero and zero['zero']} of max |update| from DDP's (limit "
          f"{PARALLEL_ZERO_TOL})")
    check(zero is not None and zero["zero_no_gather"] >= PARALLEL_ZERO_FAULT_FLOOR,
          f"a ZeRO-1 without its gather reads {zero and zero['zero_no_gather']}, under "
          f"{PARALLEL_ZERO_FAULT_FLOOR}: the check cannot see it")
    check(len(two) == 2 and sample_err <= PARALLEL_SAMPLE_TOL,
          f"DP sampling: {len(two)} volumes written, {sample_err:.3g} from one process's")
    for r, counts in enumerate(per_rank):
        check(counts == one_step, f"rank {r}'s launches {counts} differ from the one-process "
                                  f"step's {one_step}")
    for name in PATH_KERNELS:
        check(run_counts[name] > 0, f"{name} was not launched on the data-parallel path")
    check(fsdp_plain == fsdp_sharded, f"FSDP launches {fsdp_sharded} differ from the "
                                      f"unwrapped step's {fsdp_plain}")
    check(fsdp["checkpoint_bit_equal"] and fsdp["sharded_params"] > 0,
          "FSDP's full-state checkpoint did not load into one process bit for bit")
    errs = out["spatial"]["grad_err_over_max_g"]
    check(errs["spatial"] <= PARALLEL_GRAD_TOL,
          f"spatial: the slabs' summed gradients {errs['spatial']:.3g} of max |g| from one "
          f"process's (limit {PARALLEL_GRAD_TOL})")
    for fault in SPATIAL_FAULTS:
        check(errs[fault] >= PARALLEL_FAULT_FLOOR,
              f"spatial: the fault {fault} reads {errs[fault]:.3g}, under "
              f"{PARALLEL_FAULT_FLOOR}: the check cannot see it")
    spr = out["spatial"]
    check(spr["cli_volumes_written"] == [1, 0] and spr["sample_shape"] == [[64, 64, 64]]
          and spr["sample_finite"] and sp_sample_err <= PARALLEL_SAMPLE_TOL,
          f"cli.inference --spatial 2: {spr['cli_volumes_written']} volumes written of shapes "
          f"{spr['sample_shape']}, {sp_sample_err:.3g} from one process's "
          f"(limit {PARALLEL_SAMPLE_TOL})")
    for r, counts in enumerate(sp_per_rank):
        check(counts == sp_one, f"spatial rank {r}'s launches {counts} differ from the "
                                f"one-process step's {sp_one}")
    for name in PATH_KERNELS:
        check(sp_counts[name] > 0, f"{name} was not launched on the spatial path")
    emit({"phase": "parallel", "card": card, "nvidia_smi": smi_line,
          "seconds": time.perf_counter() - t0, "timing_is": label,
          **{name: {k: v for k, v in r.items() if k in ("seconds", "grad_err_over_max_g",
                                                         "zero_update_err_over_max_update",
                                                         "max_abs_err", "sample_max_abs_err",
                                                         "ms_per_step", "bf16_ms_per_step",
                                                         "checkpoint_bit_equal")}
             for name, r in out.items()}})
    return {"launches": run_counts, "spatial_launches": sp_counts,
            "gn_paths": {f"parallel_spatial_{run}": {k: c[k] for k in ("gn_sums", "gn_bwd_sums")}
                         for run, c in sp[0]["cases"].items()}}


def _spatial_attention_checks(torch, F, sp: list) -> tuple[dict, dict]:
    """The forward and backward kernels held to their plain versions (TF32
    off) and timed at every attention input the spatial runs gave them
    (rank 0's: the ranks' inputs have the same shapes), local queries
    against the gathered keys and values; a line each with the runs'
    launches at it."""
    from ldm3d_torch.cli.common import tf32_flags

    def keyed(cases):
        return {((*shape, kv) if kv != shape[1] else tuple(shape), dtype): n
                for (shape, kv, dtype), n in cases.items()}

    runs = {run: {"fwd": keyed(c["attn_fwd"]), "bwd": keyed(c["attn_bwd"])}
            for run, c in sp[0]["cases"].items()}
    gen = torch.Generator(device="cuda").manual_seed(21)
    out: tuple[dict, dict] = ({}, {})
    with tf32_flags(False):
        for i, (kind, case) in enumerate((("fwd", _fwd_case), ("bwd", _bwd_case))):
            for shape, dtype in sorted({k for r in runs.values() for k in r[kind]}, key=str):
                out[i][(shape, dtype)] = case(torch, F, dtype, shape, gen,
                                              phase=f"parallel_spatial_kernel_{kind}")
                emit({"phase": f"parallel_spatial_kernel_{kind}_launches",
                      "shape_bnhd": list(shape[:4]), "kv_len": shape[-1], "dtype": dtype,
                      "launches": {run: r[kind].get((shape, dtype), 0)
                                   for run, r in runs.items()}})
    return out


# phases that ``--phases`` runs alone, after device and build
ALONE_PHASES = ("kernel", "kernel_bwd", "kernel_c2", "kernel_conv", "train_ae", "train_ae_fp32",
                "stage1_card_vs_cpu", "sample_fused", "distill", "distill_card_vs_cpu",
                "evaluate", "presets", "follow_ups", "data_tools", "parallel")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive ldm3d_torch on one GPU and check it; with "
                                             "no arguments, every phase.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone after device and build "
                         f"(of {', '.join(ALONE_PHASES)}); prints no result line")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import ldm3d_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ldm3d_torch.configs import load_json, preset_path

    if args.phases:
        phases = args.phases.split(",")
        check(set(phases) <= set(ALONE_PHASES), f"unknown phases {phases}")
        ns = SimpleNamespace(**load_json(preset_path("config_train_32g.json")))
        counts = _module_counts(torch, ns)
        card, smi_line = phase_device(torch)
        phase_build()
        workdir_root = ROOT / "build" / "chip_smoke"
        workdir_root.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=workdir_root) as workdir:
            run = {"kernel": lambda: phase_kernel(torch, F),
                   "kernel_bwd": lambda: phase_kernel_bwd(torch, F),
                   "kernel_c2": lambda: phase_kernel_c2(torch),
                   "kernel_conv": lambda: phase_kernel_conv(torch),
                   "train_ae": lambda: phase_train_ae(torch, ns, counts, Path(workdir), card,
                                                      smi_line),
                   "train_ae_fp32": lambda: phase_train_ae(torch, ns, counts, Path(workdir),
                                                           card, smi_line, amp=False),
                   "stage1_card_vs_cpu": lambda: phase_stage1_card_vs_cpu(torch),
                   "sample_fused": lambda: phase_sample_fused(torch, ns, counts, Path(workdir),
                                                              card, smi_line),
                   "distill": lambda: shutil.rmtree(phase_distill(
                       torch, ns, counts, Path(workdir), card, smi_line)["model_dir"]),
                   "distill_card_vs_cpu": lambda: phase_distill_card_vs_cpu(torch),
                   "evaluate": lambda: phase_evaluate(torch, ns, Path(workdir), card,
                                                      smi_line),
                   "presets": lambda: _kernel_gn_all(torch, phase_presets(
                       torch, Path(workdir), card, smi_line)["gn_paths"]),
                   "follow_ups": lambda: phase_follow_ups(torch, ns, counts, Path(workdir),
                                                          card, smi_line),
                   "data_tools": lambda: _kernel_gn_all(torch, phase_data_tools(
                       torch, F, ns, counts, Path(workdir), card, smi_line)["gn_paths"]),
                   "parallel": lambda: _kernel_gn_all(torch, phase_parallel(
                       torch, ns, Path(workdir), card, smi_line)["gn_paths"])}
            for name in phases:
                run[name]()
        emit({"phase": "done", "phases": phases})
        print(smi_line, flush=True)
        return 0

    ns = SimpleNamespace(**load_json(preset_path("config_train_32g.json")))
    counts = _module_counts(torch, ns)
    card, smi_line = phase_device(torch)
    phase_build()
    workdir_root = ROOT / "build" / "chip_smoke"
    workdir_root.mkdir(parents=True, exist_ok=True)
    # data_tools first, while no earlier phase holds blocks of the caching
    # allocator: its memory gates read the allocator's peaks
    with tempfile.TemporaryDirectory(dir=workdir_root) as workdir:
        both = ("bfloat16", "float32")
        data_tools = phase_data_tools(
            torch, F, ns, counts, Path(workdir), card, smi_line,
            checked=({(s, d) for s in FWD_KERNEL_SHAPES for d in both},
                     {(s, d) for s in BWD_KERNEL_SHAPES for d in both}))
    fwd = phase_kernel(torch, F)
    bwd = phase_kernel_bwd(torch, F)
    phase_kernel_c2(torch)
    with tempfile.TemporaryDirectory(dir=workdir_root) as workdir:
        sample_launches, sample_gn = phase_main_path(torch, ns, counts, Path(workdir), card,
                                                     smi_line)
        phase_sample_fused(torch, ns, counts, Path(workdir), card, smi_line)
        train = phase_train(torch, ns, counts, Path(workdir), card, smi_line)
        train_fp32 = phase_train(torch, ns, counts, Path(workdir), card, smi_line, amp=False)
        train_ae = phase_train_ae(torch, ns, counts, Path(workdir), card, smi_line)
        train_ae_fp32 = phase_train_ae(torch, ns, counts, Path(workdir), card, smi_line,
                                       amp=False)
        serve = phase_serve(torch, ns, counts, Path(workdir), card, smi_line)
        distill = phase_distill(torch, ns, counts, Path(workdir), card, smi_line,
                                stage2_per_step=train["launches_per_step"])
        phase_evaluate(torch, ns, Path(workdir), card, smi_line, model_dir=distill["model_dir"])
        presets = phase_presets(torch, Path(workdir), card, smi_line)
        follow_ups = phase_follow_ups(torch, ns, counts, Path(workdir), card, smi_line)
        parallel = phase_parallel(torch, ns, Path(workdir), card, smi_line)
    gn = phase_kernel_gn(torch, {"sampling": sample_gn, "training": train.pop("gn_cases"),
                                 **{f"distilling_{run}": r.pop("gn_cases")
                                    for run, r in distill["runs"].items()},
                                 "training_fp32": train_fp32.pop("gn_cases"),
                                 "training_ae": train_ae.pop("gn_cases"),
                                 "training_ae_fp32": train_ae_fp32.pop("gn_cases"),
                                 "serving": serve.pop("gn_cases"), **presets["gn_paths"],
                                 **data_tools.pop("gn_paths"), **parallel.pop("gn_paths")})
    phase_gn_host(torch)
    conv = phase_kernel_conv(torch)
    phase_card_vs_cpu(torch)
    phase_train_card_vs_cpu(torch)
    phase_stage1_card_vs_cpu(torch)
    phase_distill_card_vs_cpu(torch)

    emit({"phase": "done"})
    emit({"kernels": _kernel_summary(fwd, bwd, gn, sample_launches, train, train_fp32, serve,
                                     conv, train_ae, train_ae_fp32, distill,
                                     presets["launches"], follow_ups, data_tools,
                                     parallel)})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
