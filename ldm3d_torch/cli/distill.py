"""Progressive-distillation CLI (stage 3, optional): halve the sampler's steps.

The port of ``ldm3d_tpu/cli/distill.py``: loads the trained two-stage
checkpoints (the frozen VAE and the ``best`` UNet, or its ``ema`` with
``--use-ema``), then runs R halving rounds of progressive distillation
(:mod:`ldm3d_torch.training.distill`). Round r trains a student, copied from
the current teacher, to match two teacher DDIM jumps with one on a grid of
``teacher_steps / 2^(r+1)`` steps; the student becomes the next round's
teacher, and a round after the first distils in the student's
parameterisation. Guidance (``--guidance-distill``) is distilled on the first
round only. The final student is saved as the diffusion model's
``distilled`` role with its sampling grid in the meta; ``inference
--use-distilled``, ``evaluate --use-distilled`` and the server's
``sampler="distilled"`` sample it through
:class:`ldm3d_torch.diffusion.GridDDIMScheduler`.

The losses stay on the device until a round ends (no host sync a step).

Data parallelism (``-g N``, ``--multihost``): each rank distils on its
share of the global batch with the global batch's draws (its rows kept) and
the gradients averaged over the ranks; the LR is the configured one at any
world size, as in JAX. The round's losses are the ranks' means. Rank 0
writes the ``distilled`` checkpoint.

Usage: python -m ldm3d_torch.cli.distill -c CONFIG -e ENV [--teacher-steps 64]
       [--rounds 3] [--steps-per-round 2000] [--lr LR] [--student-prediction P]
       [--unconditional] [--guidance-distill W] [--use-ema] [--amp]
       [--device cuda|cpu] [-g N] [--multihost]
``--pipeline``, ``--spatial`` and ``--tensor`` raise the JAX CLI's
``ValueError``; every other flag of the JAX parser whose path is not ported
raises ``NotImplementedError`` naming its ROADMAP item
(``ldm3d_torch.cli.common.UNPORTED``).
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np
import torch

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.cli.common import (
    build_parser,
    cli_main,
    env_seed,
    global_batch_size,
    launch_data_parallel,
    load_two_stage,
    model_dtype,
    reject_unported,
    setup,
    track_run,
)
from ldm3d_torch.cli.train_diffusion import _to_device
from ldm3d_torch.data import prepare_dataloader
from ldm3d_torch.diffusion import DDPMScheduler
from ldm3d_torch.parallel import DataParallel, mesh
from ldm3d_torch.training import (
    DistillConfig,
    TrainState,
    make_diffusion_optimizer,
    make_distillation_step,
    student_timesteps,
)
from ldm3d_torch.utils import TrainContext

log = logging.getLogger("distill")


def build_parser_distill():
    parser = build_parser("progressive distillation of the diffusion UNet, stage 3 "
                          "(PyTorch port)")
    parser.add_argument("--teacher-steps", type=int, default=64,
                        help="starting DDIM grid size N; each round halves it "
                             "(final sampler = N / 2^rounds steps)")
    parser.add_argument("--rounds", type=int, default=3,
                        help="number of halvings (e.g. 64 -> 8 with 3 rounds)")
    parser.add_argument("--steps-per-round", type=int, default=2000,
                        help="optimizer steps per halving round")
    parser.add_argument("--lr", type=float, default=None,
                        help="distillation learning rate (default: the config's diffusion lr "
                             "/ 10)")
    parser.add_argument("--student-prediction", choices=("epsilon", "sample", "v_prediction"),
                        default=None,
                        help="the student's regression parameterisation (default: the "
                             "teacher's); v_prediction is better behaved at very few steps")
    parser.add_argument("--unconditional", action="store_true",
                        help="distil without concat conditioning")
    parser.add_argument("--guidance-distill", type=float, default=1.0,
                        help="bake classifier-free guidance at this weight into the student "
                             "(first round only); needs a conditional model trained with "
                             "--cond-dropout")
    parser.add_argument("--use-ema", action="store_true",
                        help="distil from the EMA teacher weights (trained with --ema-decay)")
    return parser


def _check_args(args) -> None:
    """The JAX CLI's argument contracts, before any checkpoint or data."""
    if args.pipeline > 1 or args.spatial > 1 or args.tensor > 1:
        raise ValueError("distillation runs data-parallel; drop --pipeline/--spatial/--tensor")
    if args.rounds < 1:
        raise ValueError("--rounds must be >= 1")
    if args.teacher_steps % (1 << args.rounds):
        raise ValueError(f"--teacher-steps {args.teacher_steps} must be divisible by "
                         f"2^rounds = {1 << args.rounds}")
    if args.unconditional and args.guidance_distill != 1.0:
        raise ValueError("--guidance-distill needs a conditional model "
                         "(incompatible with --unconditional)")


@cli_main
def main(argv=None, timings: dict | None = None) -> float:
    """Run the CLI; returns the final round's loss (the mean of its last 10
    steps). When ``timings`` is a dict it receives ``step_ms``, a list per
    round of each step's ms (CUDA events on the card, read once the round
    ends; host clock on the CPU), ``distill_loss`` and ``grad_norm``, a list
    per round of each step's value, and ``teacher_params_with_grad``, per
    round the teacher parameters that hold a gradient after it (0)."""
    args = build_parser_distill().parse_args(argv)
    _check_args(args)
    reject_unported(args)
    launched, out = launch_data_parallel(args, main, argv, timings)
    if launched:
        return out
    args, device = setup(args)
    dp = DataParallel.current()
    dt = model_dtype(args)
    train_cfg = args.diffusion_train
    if timings is None:
        timings = {}
    for key in ("step_ms", "distill_loss", "grad_norm", "teacher_params_with_grad"):
        timings.setdefault(key, [])

    # data: the stage-2 pairs and crops (the conditions must match training)
    size_divisible = 2 ** (len(args.autoencoder_def["channels"])
                           + len(args.diffusion_def["channels"]) - 2)
    batch_size = global_batch_size(train_cfg["batch_size"], mesh.world())
    train_loader, _ = prepare_dataloader(args, batch_size, train_cfg["patch_size"],
                                         randcrop=False, size_divisible=size_divisible)

    # the frozen VAE, the teacher UNet and its scale factor
    ae, unet, _, scale_factor = load_two_stage(args, device, dt, use_ema=args.use_ema)
    ae.requires_grad_(False)
    teacher = unet.requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(env_seed(args))

    sched_cfg = TrainContext(args).scheduler_config()
    scheduler = DDPMScheduler.create(
        num_train_timesteps=sched_cfg["num_train_timesteps"],
        schedule=sched_cfg.get("schedule", "scaled_linear_beta"),
        beta_start=sched_cfg["beta_start"], beta_end=sched_cfg["beta_end"],
        prediction_type=sched_cfg["prediction_type"])
    if args.student_prediction and args.student_prediction != scheduler.prediction_type:
        log.info("student parameterization: %s (teacher: %s)",
                 args.student_prediction, scheduler.prediction_type)

    lr = args.lr if args.lr is not None else train_cfg["lr"] * 0.1
    losses_final = float("nan")
    for r in range(args.rounds):
        n_teacher = args.teacher_steps >> r
        # round 0 distils the original teacher; later rounds distil the
        # previous student, which already regresses the student's
        # parameterisation
        teacher_sched = scheduler if r == 0 else scheduler.replace(
            prediction_type=args.student_prediction or scheduler.prediction_type)
        cfg = DistillConfig(teacher_steps=n_teacher, conditional=not args.unconditional,
                            student_prediction_type=args.student_prediction,
                            guidance_scale=args.guidance_distill if r == 0 else 1.0)
        step = make_distillation_step(unet, ae, teacher_sched, cfg, dp=dp)
        student = copy.deepcopy(teacher).requires_grad_(True).train()
        state = TrainState(student, make_diffusion_optimizer(student.parameters(),
                                                             lambda _count: lr, dp=dp))
        t0, seen, epoch = time.time(), 0, 0
        losses, norms, spans = [], [], []
        while seen < args.steps_per_round:
            seen_before = seen
            for batch in train_loader.epoch(epoch):
                if seen >= args.steps_per_round:
                    break
                span = _Span(device)
                pair = _to_device({"image": batch["image"], "label": batch["label"]}, device)
                metrics = step(state, teacher, pair, scale_factor, gen)
                span.end()
                spans.append(span)
                # kept on the device: a float() here would sync the host a step
                losses.append(metrics["distill_loss"])
                norms.append(metrics["grad_norm"])
                seen += 1
            if seen == seen_before:
                raise RuntimeError("train loader yielded no batches this epoch — dataset "
                                   "smaller than the global batch? (would loop forever)")
            epoch += 1
        if dp is not None and losses:  # the global batch's losses (one all-reduce a round)
            losses = list(dp.mean(torch.stack(losses)))
        losses = [float(x) for x in losses]
        timings["step_ms"].append([s.ms() for s in spans])
        timings["distill_loss"].append(losses)
        timings["grad_norm"].append([float(x) for x in norms])
        timings["teacher_params_with_grad"].append(
            sum(p.grad is not None for p in teacher.parameters()))
        losses_final = float(np.mean(losses[-10:])) if losses else float("nan")
        log.info("round %d: %d-step teacher -> %d-step student, %d steps, "
                 "loss %.5f -> %.5f (%.1fs)", r, n_teacher, n_teacher // 2, seen,
                 float(np.mean(losses[:10])), losses_final, time.time() - t0)
        # the student becomes the frozen teacher: without its gradients and
        # the Adam moments
        state.optimizer.zero_grad()
        del state
        teacher = student.requires_grad_(False).eval()

    final_steps = args.teacher_steps >> args.rounds
    grid = student_timesteps(scheduler.num_train_timesteps, 2 * final_steps)
    ckpt = CheckpointManager(args.model_dir, "diffusion")
    ckpt.save("distilled", {"state_dict": teacher.state_dict()}, meta={
        "timesteps": [int(t) for t in grid],
        "num_steps": int(final_steps),
        "teacher_steps": int(args.teacher_steps),
        "rounds": int(args.rounds),
        "scale_factor": float(scale_factor),
        "prediction_type": args.student_prediction or scheduler.prediction_type,
        "teacher_role": "ema" if args.use_ema else "best",
        "guidance_scale": float(args.guidance_distill),
        "final_loss": losses_final,
    })
    log.info("saved %d-step distilled sampler (grid %s) to %s",
             final_steps, [int(t) for t in grid], ckpt.path("distilled"))
    track_run(args, "diffusion", {"distill_final_loss": losses_final,
                                  "distilled_steps": final_steps})
    return losses_final


class _Span:
    """One step's time: CUDA events on the card (read after a later sync),
    the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start, self.stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def end(self) -> None:
        if self.cuda:
            self.stop.record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.stop.synchronize()
            return self.start.elapsed_time(self.stop)
        return (self.t1 - self.t0) * 1e3


if __name__ == "__main__":
    main()
