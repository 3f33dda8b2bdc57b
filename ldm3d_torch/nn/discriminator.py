"""3D PatchGAN discriminator of the stage-1 VAE-GAN.

The port of ``ldm3d_tpu/nn/discriminator.py`` (MONAI's ``PatchDiscriminator``
as the reference builds it: ``num_layers_d=3, channels=32,
norm="INSTANCE"``). ``forward`` takes an NDHWC volume and returns the list
of feature maps with the logits map last, each NDHWC, so callers keep the
reference's ``discriminator(x)[-1]`` idiom.

Padding. The 4x4x4 convs pad as flax's ``SAME`` does: for a dim of size n
at stride s, ``total = max((ceil(n / s) - 1) * s + 4 - n, 0)``, ``lo = total
// 2`` before and ``total - lo`` after. At stride 1 that is (1, 2); at
stride 2 it is (1, 1) for an even n and (1, 2) for an odd one, so the pads
are taken from each input's own size.

Instance norm is GroupNorm with one group per channel, epsilon 1e-5, and a
unit scale and zero bias that are constants, not parameters: it runs
:class:`~ldm3d_torch.nn.blocks.GroupNormAffine`, so its sums run the
GroupNorm kernels on the card (B4 forward, B5 backward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ldm3d_torch.nn.blocks import Conv3D, GroupNormAffine, to_channels_last

__all__ = ["PatchDiscriminator3D", "same_pads"]


def same_pads(n: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax ``SAME`` padding ``(lo, hi)`` of one dim of size ``n``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class _SameConv(Conv3D):
    """A ``Conv3D`` (lecun-normal init, zero bias) with flax ``SAME`` padding
    taken from each input's spatial size; the output in ``channels_last_3d``
    (the layout the GroupNorm kernels read), which a one-channel input may
    not give by itself."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int):
        super().__init__(in_channels, features, kernel=kernel, stride=stride, padding="valid")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads: list[int] = []
        for n in reversed(x.shape[2:]):  # F.pad takes the last dim first
            pads.extend(same_pads(n, self.kernel, self.stride))
        out = super().forward(F.pad(x, pads))
        return out.contiguous(memory_format=torch.channels_last_3d)


class _InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the voxels with fp32
    statistics: GroupNorm with ``groups == channels`` and identity affine."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(channels), persistent=False)
        self.register_buffer("shift", torch.zeros(channels), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return GroupNormAffine.apply(x, self.scale, self.shift, x.shape[1], self.eps)


class PatchDiscriminator3D(nn.Module):
    def __init__(self, num_layers_d: int = 3, channels: int = 32, in_channels: int = 1,
                 out_channels: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers_d = num_layers_d
        self.compute_dtype = compute_dtype
        ch_in, ch = in_channels, channels
        for layer in range(num_layers_d):
            self.add_module(f"conv_{layer}", _SameConv(ch_in, ch, kernel=4, stride=2))
            if layer > 0:  # the first layer has no norm, the PatchGAN convention
                self.add_module(f"norm_{layer}", _InstanceNorm(ch))
            ch_in, ch = ch, ch * 2
        self.conv_out = _SameConv(ch_in, out_channels, kernel=4, stride=1)

    @classmethod
    def from_config(cls, **kw) -> "PatchDiscriminator3D":
        """Build from MONAI's ``PatchDiscriminator`` keyword surface; only
        3 spatial dims and INSTANCE norm are supported."""
        if kw.pop("spatial_dims", 3) != 3:
            raise ValueError("ldm3d_torch targets spatial_dims=3")
        norm = kw.pop("norm", "INSTANCE")
        if str(norm).upper() != "INSTANCE":
            raise ValueError(f"only INSTANCE norm is supported, got {norm!r}")
        dtype = kw.pop("dtype", torch.float32)
        return cls(
            num_layers_d=kw.pop("num_layers_d", 3),
            channels=kw.pop("channels", 32),
            in_channels=kw.pop("in_channels", 1),
            out_channels=kw.pop("out_channels", 1),
            compute_dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
        )

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NDHWC volume -> the NDHWC feature maps of every layer, then the
        logits map, in the compute dtype."""
        feats: list[torch.Tensor] = []
        h = to_channels_last(x.to(self.compute_dtype))
        for layer in range(self.num_layers_d):
            h = getattr(self, f"conv_{layer}")(h)
            if layer > 0:
                h = getattr(self, f"norm_{layer}")(h)
            h = F.leaky_relu(h, negative_slope=0.2)
            feats.append(h)
        feats.append(self.conv_out(h))
        return [f.permute(0, 2, 3, 4, 1) for f in feats]
