"""Registry mapping config ``_target_`` class paths to the port's constructors.

The port's own copy of ``ldm3d_tpu/configs/registry.py``. The bundled presets
name the JAX package's classes (``ldm3d_tpu.nn.AutoencoderKL``) and the
reference configs name MONAI's (``monai.networks.nets.AutoencoderKL``) or a
stale local alias (``networks.AutoencoderKL``); every one of those names
resolves to the corresponding ``ldm3d_torch`` module here, so the same JSON
files build the port's models unchanged, the stage-1 discriminator (MONAI's
``PatchDiscriminator``) included.
"""

from __future__ import annotations

from typing import Callable, Mapping

__all__ = ["default_registry", "register"]

_EXTRA: dict[str, Callable] = {}


def register(name: str, ctor: Callable) -> None:
    """Register an additional ``_target_`` name (used by tests/extensions)."""
    _EXTRA[name] = ctor


def default_registry() -> Mapping[str, Callable]:
    # imported lazily so the config layer stays importable without the models
    from ldm3d_torch.nn.autoencoder_kl import AutoencoderKL
    from ldm3d_torch.nn.diffusion_unet import DiffusionUNet3D
    from ldm3d_torch.nn.discriminator import PatchDiscriminator3D

    reg: dict[str, Callable] = {}
    for prefix in ("ldm3d_torch.nn", "ldm3d_tpu.nn"):
        reg[f"{prefix}.AutoencoderKL"] = AutoencoderKL.from_config
        reg[f"{prefix}.DiffusionUNet3D"] = DiffusionUNet3D.from_config
        reg[f"{prefix}.PatchDiscriminator3D"] = PatchDiscriminator3D.from_config
    for prefix in ("monai.networks.nets", "networks"):
        reg[f"{prefix}.AutoencoderKL"] = AutoencoderKL.from_config
        reg[f"{prefix}.DiffusionModelUNet"] = DiffusionUNet3D.from_config
    reg["monai.networks.nets.PatchDiscriminator"] = PatchDiscriminator3D.from_config
    reg.update(_EXTRA)
    return reg
