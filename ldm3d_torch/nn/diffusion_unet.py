"""3D diffusion UNet with timestep conditioning (stage 2 of the LDM).

Counterpart of ``ldm3d_tpu/nn/diffusion_unet.py``: sinusoidal timestep
embedding + MLP, time-conditioned ResBlocks, self-attention at the configured
levels with ``num_head_channels``, skip connections concatenated as
``[h, skip]``, and a zero-initialised output conv. Concat conditioning is the
caller's: it passes ``in_channels = latent + condition`` inputs.

``forward`` takes and returns NDHWC; see :mod:`ldm3d_torch.nn.blocks` for the
layout inside. Submodules carry the Flax names (``down_{l}_res_{b}``,
``up_{l}_attn_{b}``, ``mid_attn``, ...).

``mid_depth`` adds the JAX package's uniform stack of (ResBlock, Attention)
pairs, :class:`MidBlock3D`, at the bottleneck between ``mid_attn`` and
``mid_res_2``: ``mid_stack.{i}`` for i < ``mid_depth``, run in order.
``mid_depth=0`` (the default) is the reference architecture. The
bottleneck is split into ``mid_entry`` / ``mid_stack_apply`` / ``mid_exit``
as in JAX, where pipeline parallelism cuts the model.

``remat`` (False, True/``"full"`` or ``"convs"``) runs the down and up
ResBlocks and each ``mid_stack`` layer under
:func:`~ldm3d_torch.nn.blocks.remat_wrapped`, as JAX wraps them;
``mid_res_1``, ``mid_attn``, ``mid_res_2`` and the level attention blocks
run as they are.
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
    check_remat,
    remat_wrapped,
    to_channels_last,
)

__all__ = ["DiffusionUNet3D", "MidBlock3D"]


def _per_level(value, levels: int) -> tuple:
    return (value,) * levels if isinstance(value, int) else tuple(value)


class MidBlock3D(nn.Module):
    """One uniform bottleneck layer: a time-conditioned ResBlock ``res``, then
    an attention block ``attn``, both at ``channels`` in and out."""

    def __init__(self, channels: int, time_dim: int, num_head_channels: int = 0,
                 num_groups: int = 32, norm_eps: float = 1e-6):
        super().__init__()
        self.res = TimeResBlock3D(channels, channels, time_dim, num_groups, norm_eps)
        self.attn = AttentionBlock3D(channels, num_head_channels, num_groups, norm_eps)

    def forward(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        return self.attn(self.res(h, temb))


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
        mid_depth: int = 0,
        remat=False,
    ):
        super().__init__()
        check_remat(remat)
        self.remat = remat
        self.in_channels, self.out_channels = in_channels, out_channels
        self.mid_depth = mid_depth
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
        self.mid_stack = nn.ModuleList(
            MidBlock3D(self.channels[-1], time_dim, num_head_channels[-1], g, eps)
            for _ in range(mid_depth))
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
            mid_depth=kw.pop("mid_depth", 0),
            remat=kw.pop("remat", False),
        )

    def mid_entry(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        return self.mid_attn(self.mid_res_1(h, temb))

    def mid_stack_apply(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        """The uniform bottleneck stack, in order (``h`` unchanged at depth 0)."""
        for block in self.mid_stack:
            h = remat_wrapped(block, self.remat)(h, temb)
        return h

    def _block(self, kind: str, name: str, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        if kind == "res":
            return remat_wrapped(block, self.remat)(h, temb)
        return block(h)

    def mid_exit(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        return self.mid_res_2(h, temb)

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
                h = self._block(kind, name, h, temb)
        h = self.mid_exit(self.mid_stack_apply(self.mid_entry(h, temb), temb), temb)
        for kind, name in self._up:
            if kind == "skip":
                h = torch.cat([h, skips.pop()], dim=1)
            else:
                h = self._block(kind, name, h, temb)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.permute(0, 2, 3, 4, 1)
