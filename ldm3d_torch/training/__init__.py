from ldm3d_torch.training.distill import (
    DistillConfig,
    DistillDraws,
    draw_distill,
    make_distillation_step,
    student_timesteps,
)
from ldm3d_torch.training.lr_schedules import build_lr_schedule, scale_lr_for_world
from ldm3d_torch.training.preemption import GracefulShutdown
from ldm3d_torch.training.stage1 import (
    Stage1Config,
    Stage1Draws,
    draw_stage1,
    make_optimizer,
    make_stage1_eval_step,
    make_stage1_train_step,
)
from ldm3d_torch.training.stage2 import (
    Stage2Config,
    Stage2Draws,
    compute_scale_factor,
    draw_stage2,
    make_diffusion_optimizer,
    make_stage2_eval_step,
    make_stage2_train_step,
    make_stage2_train_step_latents,
    min_snr_weights,
)
from ldm3d_torch.training.state import ClippedAdam, TrainState, clip_by_global_norm_, global_norm

__all__ = ["DistillConfig", "DistillDraws", "draw_distill", "make_distillation_step",
           "student_timesteps", "build_lr_schedule", "scale_lr_for_world", "GracefulShutdown", "Stage1Config",
           "Stage1Draws", "draw_stage1", "make_optimizer",
           "make_stage1_eval_step", "make_stage1_train_step", "Stage2Config", "Stage2Draws",
           "compute_scale_factor", "draw_stage2", "make_diffusion_optimizer",
           "make_stage2_eval_step", "make_stage2_train_step", "make_stage2_train_step_latents",
           "min_snr_weights", "ClippedAdam", "TrainState", "clip_by_global_norm_", "global_norm"]
