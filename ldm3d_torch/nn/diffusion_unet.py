"""3D diffusion UNet with timestep conditioning (stage 2 of the LDM).

Counterpart of ``ldm3d_tpu/nn/diffusion_unet.py``: sinusoidal timestep
embedding + MLP, time-conditioned ResBlocks, self-attention at the configured
levels with ``num_head_channels``, skip connections concatenated as
``[h, skip]``, and a zero-initialised output conv. Concat conditioning is the
caller's: it passes ``in_channels = latent + condition`` inputs.

``forward`` takes and returns NDHWC; see :mod:`ldm3d_torch.nn.blocks` for the
layout inside. Submodules carry the Flax names (``down_{l}_res_{b}``,
``up_{l}_attn_{b}``, ``mid_attn``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ldm3d_torch.nn.blocks import (
    AttentionBlock3D,
    Downsample3D,
    GroupNorm32,
    TimeResBlock3D,
    TimestepEmbedding,
    Upsample3D,
    _conv3,
    to_channels_last,
)

__all__ = ["DiffusionUNet3D"]


def _per_level(value, levels: int) -> tuple:
    return (value,) * levels if isinstance(value, int) else tuple(value)


class DiffusionUNet3D(nn.Module):
    def __init__(
        self,
        in_channels: int = 32,
        out_channels: int = 16,
        channels: Sequence[int] = (256, 512, 1024),
        attention_levels: Sequence[bool] = (False, True, True),
        num_head_channels: Sequence[int] = (0, 64, 64),
        num_res_blocks: Sequence[int] = (2, 2, 2),
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.channels = tuple(channels)
        self.compute_dtype = compute_dtype
        levels = len(self.channels)
        g, eps = norm_num_groups, norm_eps
        time_dim = 4 * self.channels[0]

        self.time_embed = TimestepEmbedding(self.channels[0], time_dim)
        self.conv_in = _conv3(in_channels, self.channels[0])

        # (kind, name) in forward order; "skip" marks where the down path
        # saves a skip and where the up path concatenates one
        self._down: list[tuple[str, str]] = []
        self._up: list[tuple[str, str]] = []
        skip_ch = [self.channels[0]]
        ch = self.channels[0]
        for level in range(levels):
            for block in range(num_res_blocks[level]):
                self._add(self._down, "res", f"down_{level}_res_{block}",
                          TimeResBlock3D(ch, self.channels[level], time_dim, g, eps))
                ch = self.channels[level]
                if attention_levels[level]:
                    self._add(self._down, "attn", f"down_{level}_attn_{block}",
                              AttentionBlock3D(ch, num_head_channels[level], g, eps))
                self._down.append(("skip", ""))
                skip_ch.append(ch)
            if level < levels - 1:
                self._add(self._down, "down", f"down_{level}_downsample", Downsample3D(ch, ch))
                self._down.append(("skip", ""))
                skip_ch.append(ch)

        self.mid_res_1 = TimeResBlock3D(ch, self.channels[-1], time_dim, g, eps)
        self.mid_attn = AttentionBlock3D(self.channels[-1], num_head_channels[-1], g, eps)
        self.mid_res_2 = TimeResBlock3D(self.channels[-1], self.channels[-1], time_dim, g, eps)

        for idx, level in enumerate(reversed(range(levels))):
            for block in range(num_res_blocks[level] + 1):
                self._up.append(("skip", ""))
                self._add(self._up, "res", f"up_{level}_res_{block}",
                          TimeResBlock3D(ch + skip_ch.pop(), self.channels[level], time_dim, g, eps))
                ch = self.channels[level]
                if attention_levels[level]:
                    self._add(self._up, "attn", f"up_{level}_attn_{block}",
                              AttentionBlock3D(ch, num_head_channels[level], g, eps))
            if idx < levels - 1:
                self._add(self._up, "up", f"up_{level}_upsample", Upsample3D(ch, ch))

        self.norm_out = GroupNorm32(ch, g, eps)
        self.conv_out = _conv3(ch, out_channels, zero_init=True)

    def _add(self, order: list, kind: str, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        order.append((kind, name))

    @classmethod
    def from_config(cls, **kw) -> "DiffusionUNet3D":
        """Build from the reference's config keyword surface
        (``config_train_32g.json:40-49``); unknown keys are ignored."""
        if kw.pop("spatial_dims", 3) != 3:
            raise ValueError("ldm3d_torch targets spatial_dims=3")
        if kw.pop("mid_depth", 0) > 0:
            raise NotImplementedError(
                "mid_depth > 0 (the uniform bottleneck stack) is not ported yet: "
                "ROADMAP.md queue A, 'UNet mid_depth stack'")
        channels = tuple(kw.pop("channels", (256, 512, 1024)))
        levels = len(channels)
        dtype = kw.pop("dtype", torch.float32)
        return cls(
            in_channels=kw.pop("in_channels", 32),
            out_channels=kw.pop("out_channels", 16),
            channels=channels,
            attention_levels=tuple(kw.pop("attention_levels", (False,) * levels)),
            num_head_channels=_per_level(kw.pop("num_head_channels", 0), levels),
            num_res_blocks=_per_level(kw.pop("num_res_blocks", 2), levels),
            norm_num_groups=kw.pop("norm_num_groups", 32),
            norm_eps=kw.pop("norm_eps", 1e-6),
            compute_dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
        )

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """Predict eps-hat for ``x`` ``(B, D, H, W, in_channels)`` at integer
        ``timesteps`` ``(B,)``; returns ``(B, D, H, W, out_channels)``."""
        temb = self.time_embed(timesteps, self.compute_dtype)
        h = self.conv_in(to_channels_last(x.to(self.compute_dtype)))
        skips = [h]
        for kind, name in self._down:
            if kind == "skip":
                skips.append(h)
            else:
                h = getattr(self, name)(h, temb) if kind == "res" else getattr(self, name)(h)
        h = self.mid_res_2(self.mid_attn(self.mid_res_1(h, temb)), temb)
        for kind, name in self._up:
            if kind == "skip":
                h = torch.cat([h, skips.pop()], dim=1)
            else:
                h = getattr(self, name)(h, temb) if kind == "res" else getattr(self, name)(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 4, 1)
