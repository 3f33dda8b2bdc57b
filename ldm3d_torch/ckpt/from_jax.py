"""Weight bridge: a JAX (Flax) param tree -> the port's ``state_dict``.

The port's modules carry the Flax tree's names, so a leaf at
``encoder/down_0_res_0/conv1/kernel`` becomes ``encoder.down_0_res_0.conv1.weight``.
The leaf rules:

* 3D conv ``kernel`` ``(D, H, W, I, O)`` -> ``weight`` ``(O, I, D, H, W)``;
* 2D conv ``kernel`` ``(H, W, I, O)`` -> ``weight`` ``(O, I, H, W)`` (LPIPS);
* Dense ``kernel`` ``(in, out)`` -> ``weight`` ``(out, in)``;
* GroupNorm ``scale`` -> ``weight``; every ``bias`` -> ``bias``
  (``Upsample3D``'s parameters sit at ``conv/{kernel,bias}`` in both trees);
* LPIPS's per-stage channel weights ``lin_{i}`` keep their name;
* the UNet's ``mid_stack`` (an ``nn.scan`` over ``MidBlock3D`` with
  ``variable_axes={"params": 0}``) stores every leaf with a leading
  ``mid_depth`` axis: layer i of ``mid_stack/res/conv1/kernel`` becomes
  ``mid_stack.{i}.res.conv1.weight``.

The tree's leaves are numpy arrays (``jax.device_get`` of the params). The
bridge raises if a leaf has no parameter to go to, if a parameter is left
unfilled, or if a shape disagrees.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_jax", "unet_state_dict_from_jax", "autoencoder_state_dict_from_jax",
           "discriminator_state_dict_from_jax", "lpips_state_dict_from_jax"]

_LIN = re.compile(r"lin_\d+")
# subtrees whose leaves are stacked along a leading layer axis (nn.scan)
_STACKED = ("mid_stack",)


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out: dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            if k in _STACKED:
                for path, arr in _flatten(v).items():
                    for i, layer in enumerate(arr):
                        out[prefix + (k, str(i)) + path] = layer
            else:
                out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _convert(path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim} is neither conv nor Dense")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf != "bias" and not (_LIN.fullmatch(leaf) and arr.ndim == 1):
        raise ValueError(f"{'/'.join(path)}: unknown leaf {leaf!r}")
    return ".".join([*mods, leaf]), np.ascontiguousarray(arr, dtype=np.float32)


def state_dict_from_jax(params: Mapping[str, Any], model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert ``params`` into a state_dict for ``model``, consuming every leaf
    and filling every parameter."""
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    unconsumed = []
    for path, arr in _flatten(params).items():
        key, value = _convert(path, arr)
        if key not in target:
            unconsumed.append("/".join(path))
            continue
        if tuple(target[key].shape) != value.shape:
            raise ValueError(f"{'/'.join(path)} -> {key}: shape {value.shape} does not match "
                             f"the port's {tuple(target[key].shape)}")
        out[key] = torch.tensor(value)
    unfilled = sorted(set(target) - set(out))
    if unconsumed or unfilled:
        raise ValueError(f"weight bridge mismatch: JAX leaves left unconsumed {unconsumed}; "
                         f"port parameters left unfilled {unfilled}")
    return out


def unet_state_dict_from_jax(params: Mapping[str, Any], model: nn.Module) -> dict[str, torch.Tensor]:
    """``DiffusionUNet3D`` params -> the port's ``DiffusionUNet3D`` state_dict."""
    return state_dict_from_jax(params, model)


def autoencoder_state_dict_from_jax(params: Mapping[str, Any],
                                    model: nn.Module) -> dict[str, torch.Tensor]:
    """``AutoencoderKL`` params -> the port's ``AutoencoderKL`` state_dict."""
    return state_dict_from_jax(params, model)


def discriminator_state_dict_from_jax(params: Mapping[str, Any],
                                      model: nn.Module) -> dict[str, torch.Tensor]:
    """``PatchDiscriminator3D`` params -> the port's ``PatchDiscriminator3D``
    state_dict (its InstanceNorms have no parameters in either tree)."""
    return state_dict_from_jax(params, model)


def lpips_state_dict_from_jax(params: Mapping[str, Any],
                              model: nn.Module) -> dict[str, torch.Tensor]:
    """``LPIPS`` params (the SqueezeNet trunk's 2D convs and ``lin_{i}``) ->
    the port's ``LPIPS`` state_dict."""
    return state_dict_from_jax(params, model)
