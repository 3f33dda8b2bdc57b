from ldm3d_torch.ckpt.from_jax import (
    autoencoder_state_dict_from_jax,
    state_dict_from_jax,
    unet_state_dict_from_jax,
)

__all__ = ["state_dict_from_jax", "unet_state_dict_from_jax", "autoencoder_state_dict_from_jax"]
