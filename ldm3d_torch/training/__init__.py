from ldm3d_torch.training.lr_schedules import build_lr_schedule
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

__all__ = ["build_lr_schedule", "Stage2Config", "Stage2Draws",
           "compute_scale_factor", "draw_stage2", "make_diffusion_optimizer",
           "make_stage2_eval_step", "make_stage2_train_step", "make_stage2_train_step_latents",
           "min_snr_weights", "ClippedAdam", "TrainState", "clip_by_global_norm_", "global_norm"]
