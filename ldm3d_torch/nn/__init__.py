from ldm3d_torch.nn.autoencoder_kl import AutoencoderKL, Decoder3D, Encoder3D
from ldm3d_torch.nn.blocks import init_weights_
from ldm3d_torch.nn.diffusion_unet import DiffusionUNet3D
from ldm3d_torch.nn.discriminator import PatchDiscriminator3D
from ldm3d_torch.nn.lpips import LPIPS, SqueezeNetFeatures, init_lpips_, perceptual_loss_25d
from ldm3d_torch.nn import blocks

__all__ = ["AutoencoderKL", "Decoder3D", "Encoder3D", "DiffusionUNet3D", "PatchDiscriminator3D",
           "LPIPS", "SqueezeNetFeatures", "init_lpips_", "perceptual_loss_25d", "blocks",
           "init_weights_"]
