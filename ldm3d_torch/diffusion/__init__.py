from ldm3d_torch.diffusion.schedulers import (
    DDIMScheduler,
    DDPMScheduler,
    DPMSolverPPScheduler,
    GridDDIMScheduler,
    distillation_grid,
    karras_timestep_grid,
    make_betas,
    make_timestep_grid,
    pred_x0_and_eps,
)
from ldm3d_torch.diffusion import inferer

__all__ = ["DDIMScheduler", "DDPMScheduler", "DPMSolverPPScheduler", "GridDDIMScheduler",
           "distillation_grid", "karras_timestep_grid", "make_betas", "make_timestep_grid",
           "pred_x0_and_eps", "inferer"]
