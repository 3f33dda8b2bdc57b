from ldm3d_torch.diffusion.schedulers import DDIMScheduler, make_betas, make_timestep_grid
from ldm3d_torch.diffusion import inferer

__all__ = ["DDIMScheduler", "make_betas", "make_timestep_grid", "inferer"]
