from ldm3d_torch.diffusion.schedulers import (
    DDIMScheduler,
    DDPMScheduler,
    make_betas,
    make_timestep_grid,
)
from ldm3d_torch.diffusion import inferer

__all__ = ["DDIMScheduler", "DDPMScheduler", "make_betas", "make_timestep_grid", "inferer"]
