"""ldm3d_torch — the PyTorch/CUDA port of ldm3d_tpu for NVIDIA Hopper (H100).

A second package beside ``ldm3d_tpu``, which stays the reference that every
part of the port is held against. The port imports ``torch``, numpy and the
standard library, never JAX or ``ldm3d_tpu``; where it needs code of the JAX
package it keeps its own copy.

Package layout mirrors the JAX package:
  configs/    config resolver (@ref / $expr / _target_) and bundled presets
  nn/         AutoencoderKL, DiffusionUNet3D and their blocks (nn.Modules)
  ops/        attention: the hand-written CUDA flash-attention forward and
              its plain PyTorch version
  csrc/       CUDA C++ sources, built with nvcc for sm_90a at first use
  diffusion/  DDIM scheduler and the latent inferer (sampling loop)
  ckpt/       weight bridge from a JAX param tree to the port's state_dicts
  data/       synthetic pairs, NPZ val volumes, transforms
  cli/        the inference entry point
  utils/      config merging, NIfTI writer

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
