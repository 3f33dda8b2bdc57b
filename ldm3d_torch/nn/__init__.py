from ldm3d_torch.nn.autoencoder_kl import AutoencoderKL, Decoder3D, Encoder3D
from ldm3d_torch.nn.blocks import init_weights_
from ldm3d_torch.nn.diffusion_unet import DiffusionUNet3D
from ldm3d_torch.nn import blocks

__all__ = ["AutoencoderKL", "Decoder3D", "Encoder3D", "DiffusionUNet3D", "blocks", "init_weights_"]
