"""Weight bridge: a JAX (Flax) param tree -> the port's ``state_dict``.

The port's modules carry the Flax tree's names, so a leaf at
``encoder/down_0_res_0/conv1/kernel`` becomes ``encoder.down_0_res_0.conv1.weight``.
The leaf rules:

* conv ``kernel`` ``(D, H, W, I, O)`` -> ``weight`` ``(O, I, D, H, W)``;
* Dense ``kernel`` ``(in, out)`` -> ``weight`` ``(out, in)``;
* GroupNorm ``scale`` -> ``weight``; every ``bias`` -> ``bias``
  (``Upsample3D``'s parameters sit at ``conv/{kernel,bias}`` in both trees).

The tree's leaves are numpy arrays (``jax.device_get`` of the params). The
bridge raises if a leaf has no parameter to go to, if a parameter is left
unfilled, or if a shape disagrees.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_jax", "unet_state_dict_from_jax", "autoencoder_state_dict_from_jax"]


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out: dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _convert(path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim} is neither conv nor Dense")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf != "bias":
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
