"""Shared PyTorch building blocks for the 3D VAE and diffusion UNet.

Counterpart of ``ldm3d_tpu/nn/blocks.py``; module and parameter names follow
the Flax tree (``norm1``, ``conv1``, ``time_proj``, ``qkv``, ``proj``, ...) so
``ldm3d_torch.ckpt.from_jax`` maps a JAX param tree onto a ``state_dict`` by
one fixed rule.

Layout. The models' public functions take and return NDHWC, as the JAX
package does. Inside, blocks work on logical NCDHW tensors held in the
``torch.channels_last_3d`` memory format, which is NDHWC in memory: the
convolutions run channels-last, and the attention's ``(B, D*H*W, C)`` token
view of an activation is a free view whose token order is the JAX flatten of
``(D, H, W)``.

Precision. Parameters are fp32. The compute dtype is the dtype of the
activations (fp32, or bf16 under ``--amp``); each block casts its weights to
it. GroupNorm statistics are fp32 whatever the compute dtype.

Gradients. Attention and GroupNorm are autograd Functions whose backward
runs the hand-written kernels on the card (``ldm3d_torch/ops``); the rest is
PyTorch autograd.

The JAX package's depth-sharded (``spatial_axis``) and rematerialised
variants are not ported in this slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ldm3d_torch.ops.attention import volumetric_attention
from ldm3d_torch.ops.groupnorm import gn_bwd_sums, gn_sums

__all__ = [
    "Conv3D",
    "Dense",
    "GroupNorm32",
    "GroupNormAffine",
    "ResBlock3D",
    "TimeResBlock3D",
    "AttentionBlock3D",
    "Downsample3D",
    "Upsample3D",
    "sinusoidal_time_embedding",
    "TimestepEmbedding",
    "init_weights_",
    "to_channels_last",
]


def to_channels_last(x_ndhwc: torch.Tensor) -> torch.Tensor:
    """NDHWC tensor -> logical NCDHW view in the channels_last_3d format."""
    return x_ndhwc.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> None:
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


class Conv3D(nn.Module):
    """3D convolution. ``padding``: ``"same"`` (odd kernels), ``"valid"``, or
    ``"down"`` = pad (0, 1) per spatial dim, for the stride-2 downsample.

    The JAX package's few-output-channel factorised form
    (``_conv3_small_out_factorized``) computes the same sum reassociated and
    is a plain convolution here."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: str = "same", zero_init: bool = False):
        super().__init__()
        if padding not in ("same", "valid", "down"):
            raise ValueError(f"padding must be 'same', 'valid' or 'down', got {padding!r}")
        if padding == "same" and kernel % 2 == 0:
            raise ValueError(f"'same' padding needs an odd kernel, got {kernel}")
        self.kernel, self.stride, self.padding, self.zero_init = kernel, stride, padding, zero_init
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if self.zero_init:
            nn.init.zeros_(self.weight)
        else:
            _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (self.kernel - 1) // 2 if self.padding == "same" else 0
        if self.padding == "down":
            x = F.pad(x, (0, 1, 0, 1, 0, 1))
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride, padding=pad)


def _conv3(in_channels: int, features: int, kernel: int = 3, zero_init: bool = False) -> Conv3D:
    return Conv3D(in_channels, features, kernel=kernel,
                  padding="same" if kernel > 1 else "valid", zero_init=zero_init)


class Dense(nn.Module):
    """Linear layer over the last axis (``flax.linen.Dense``), weight ``(out, in)``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _per_channel(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``(B, C)`` -> ``(B, C, 1, ...)`` broadcasting against an ``ndim`` activation."""
    return t.reshape(t.shape + (1,) * (ndim - 2))


def _gn_stats(x: torch.Tensor, g: int, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, inv-std) per (batch, channel), group-combined: per-channel
    sums first (:func:`~ldm3d_torch.ops.groupnorm.gn_sums`), then the tiny
    (B, C) -> (B, G) combine (``ldm3d_tpu/nn/blocks.py:167-198``)."""
    b, c = x.shape[:2]
    s1c, s2c = gn_sums(x)
    s1 = s1c.reshape(b, g, c // g).sum(-1)
    s2 = s2c.reshape(b, g, c // g).sum(-1)
    count = float(x[0, 0].numel() * (c // g))
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return mean.repeat_interleave(c // g, dim=1), inv.repeat_interleave(c // g, dim=1)


class GroupNormAffine(torch.autograd.Function):
    """GroupNorm with the closed-form backward of ``_gn_affine_bwd``
    (``ldm3d_tpu/nn/blocks.py:214-252``). With per-group sums S1 = sum(dy*gamma)
    and S2 = sum(dy*gamma*x_hat) over the group's N voxels x channels:

        dx = a1*dy + a2*x + a3,  a1 = inv*gamma,  a2 = -inv^2 * S2 / N,
        a3 = -inv * S1 / N + mean * inv^2 * S2 / N,

    one pass over dy and x with per-(batch, channel) coefficients, in the
    activations' dtype; dscale = sum_b sum_v dy*x_hat, dbias = sum_b sum_v dy.
    It saves x and the fp32 (mean, inv) per channel, not an fp32 copy of the
    volume."""

    @staticmethod
    def forward(ctx, x, weight, bias, g: int, eps: float):
        mean_c, inv_c = _gn_stats(x, g, eps)
        a_c = inv_c * weight[None, :]
        b_c = bias[None, :] - mean_c * a_c
        ctx.save_for_backward(x, weight, mean_c, inv_c)
        ctx.g = g
        nd = x.dim()
        return x * _per_channel(a_c, nd).to(x.dtype) + _per_channel(b_c, nd).to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, mean_c, inv_c = ctx.saved_tensors
        g = ctx.g
        b, c = x.shape[:2]
        n = float(x[0, 0].numel() * (c // g))
        sum_dy_c, sum_dyx_c = gn_bwd_sums(dy, x, mean_c, inv_c)
        dscale = sum_dyx_c.sum(0)
        dbias = sum_dy_c.sum(0)
        gam = weight[None, :]
        s1 = (sum_dy_c * gam).reshape(b, g, c // g).sum(-1)
        s2 = (sum_dyx_c * gam).reshape(b, g, c // g).sum(-1)
        s1_c = s1.repeat_interleave(c // g, dim=1)
        s2_c = s2.repeat_interleave(c // g, dim=1)
        a1 = inv_c * gam
        a2 = -(inv_c * inv_c) * s2_c / n
        a3 = -inv_c * s1_c / n + mean_c * (inv_c * inv_c) * s2_c / n
        nd, od = x.dim(), x.dtype
        dx = (dy * _per_channel(a1, nd).to(od) + x * _per_channel(a2, nd).to(od)
              + _per_channel(a3, nd).to(od))
        return dx, dscale, dbias, None, None


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics regardless of the compute dtype.

    Per-(batch, channel) fp32 sums (the GroupNorm-sums kernel on the card),
    combined per group; var = E[x^2] - mean^2 clamped at 0; the affine is
    folded into one per-channel multiply-add applied in the compute dtype
    (``ldm3d_tpu/nn/blocks.py:167-261``); the backward is
    :class:`GroupNormAffine`'s closed form."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by {num_groups} groups")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return GroupNormAffine.apply(x, self.weight, self.bias, self.num_groups, self.eps)


class ResBlock3D(nn.Module):
    """norm -> silu -> conv -> norm -> silu -> conv, with a 1x1 shortcut when
    the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 32,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, num_groups, norm_eps)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels, num_groups, norm_eps)
        self.conv2 = _conv3(out_channels, out_channels)
        if in_channels != out_channels:
            self.shortcut = _conv3(in_channels, out_channels, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class TimeResBlock3D(nn.Module):
    """ResBlock with the timestep-embedding projection added after conv1."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 num_groups: int = 32, norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, num_groups, norm_eps)
        self.conv1 = _conv3(in_channels, out_channels)
        self.time_proj = Dense(time_dim, out_channels)
        self.norm2 = GroupNorm32(out_channels, num_groups, norm_eps)
        self.conv2 = _conv3(out_channels, out_channels)
        if in_channels != out_channels:
            self.shortcut = _conv3(in_channels, out_channels, kernel=1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_proj(F.silu(temb))[:, :, None, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class AttentionBlock3D(nn.Module):
    """GroupNorm -> fused qkv Dense -> attention over the D*H*W tokens -> proj
    -> residual. ``num_head_channels=0`` is one head over all channels; the
    channel axis splits as channel = head * head_dim + j."""

    def __init__(self, channels: int, num_head_channels: int = 0, num_groups: int = 32,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.heads = max(1, channels // num_head_channels) if num_head_channels else 1
        self.norm = GroupNorm32(channels, num_groups, norm_eps)
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)          # (B, N, C), N in (D, H, W) order
        qkv = self.qkv(y)
        q, k, v = (t.unflatten(-1, (self.heads, c // self.heads)) for t in qkv.chunk(3, dim=-1))
        attn = volumetric_attention(q, k, v).flatten(2)     # (B, N, C)
        out = self.proj(attn).transpose(1, 2).reshape(b, c, d, h, w)
        return x + out


class Downsample3D(nn.Module):
    """Stride-2 conv with (0, 1) padding per spatial dim: output floor(n/2)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3D(in_channels, out_channels, kernel=3, stride=2, padding="down")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample3D(nn.Module):
    """Nearest-neighbour x2 then a SAME conv3^3: the JAX package's fused
    ``_upsample_conv_fused`` computes the same sums reassociated."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _conv3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x.contiguous(memory_format=torch.channels_last_3d))


def sinusoidal_time_embedding(timesteps: torch.Tensor, dim: int,
                              max_period: float = 10000.0) -> torch.Tensor:
    """DDPM sinusoidal embedding in ``[cos | sin]`` order; fp32, ``(B, dim)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    angles = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Sinusoidal embedding -> Dense -> SiLU -> Dense."""

    def __init__(self, base_dim: int, time_dim: int):
        super().__init__()
        self.base_dim = base_dim
        self.fc1 = Dense(base_dim, time_dim)
        self.fc2 = Dense(time_dim, time_dim)

    def forward(self, timesteps: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        emb = sinusoidal_time_embedding(timesteps, self.base_dim).to(dtype)
        return self.fc2(F.silu(self.fc1(emb)))


def init_weights_(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Re-initialise every parameter as Flax does (lecun-normal kernels, zero
    biases, unit GroupNorm scales, zero-init convs kept at zero), drawing from
    ``generator``; the generator's device must be the parameters' device."""
    for m in model.modules():
        if isinstance(m, (Conv3D, Dense, GroupNorm32)):
            m.reset_parameters(generator)
    return model
