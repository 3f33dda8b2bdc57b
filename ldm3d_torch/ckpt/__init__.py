from ldm3d_torch.ckpt.from_jax import (
    autoencoder_state_dict_from_jax,
    state_dict_from_jax,
    unet_state_dict_from_jax,
)
from ldm3d_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager", "state_dict_from_jax", "unet_state_dict_from_jax",
           "autoencoder_state_dict_from_jax"]
