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

Rematerialisation. :func:`remat_wrapped` runs a block under
``torch.utils.checkpoint``: the models wrap their ResBlocks (and the UNet's
``mid_stack`` layers) with it when their ``remat`` is set, as the JAX
package's ``nn.remat`` does.

Depth sharding. :class:`Conv3D`, :class:`GroupNorm32`,
:class:`AttentionBlock3D` and :class:`Upsample3D` take an optional
``spatial_group`` (JAX's ``spatial_axis``, a
:class:`~ldm3d_torch.parallel.spatial.SpatialGroup`); with one, the block
works on this rank's depth slab and stays exact: the convolutions exchange
depth halos, GroupNorm sums its statistics (and its backward's sums) over
the group, attention gathers the keys and values of every slab.
:func:`~ldm3d_torch.parallel.spatial.spatial_clone` binds every block of a
model to a group over the same weights.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ldm3d_torch.ops.attention import volumetric_attention
from ldm3d_torch.ops.groupnorm import gn_bwd_sums, gn_sums
from ldm3d_torch.parallel.spatial import gather_tokens, halo_exchange

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
    "remat_wrapped",
    "check_remat",
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
    is a plain convolution here.

    With a ``spatial_group`` the input is this rank's depth slab: the depth
    padding comes from the neighbours' slabs (:func:`halo_exchange`, zeros at
    either end of the volume) and only H and W are padded here
    (``ldm3d_tpu/nn/blocks.py:129-136``)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: str = "same", zero_init: bool = False, spatial_group=None):
        super().__init__()
        if padding not in ("same", "valid", "down"):
            raise ValueError(f"padding must be 'same', 'valid' or 'down', got {padding!r}")
        if padding == "same" and kernel % 2 == 0:
            raise ValueError(f"'same' padding needs an odd kernel, got {kernel}")
        self.kernel, self.stride, self.padding, self.zero_init = kernel, stride, padding, zero_init
        self.spatial_group = spatial_group
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if self.zero_init:
            nn.init.zeros_(self.weight)
        else:
            _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, depth_pad: Optional[int] = None) -> torch.Tensor:
        """``depth_pad``, when given, is the depth's zero padding of a "same"
        convolution in place of its own (and of a spatial group's halo): a
        caller that brought its own depth rows passes 0."""
        pad = (self.kernel - 1) // 2 if self.padding == "same" else 0
        sg = self.spatial_group if depth_pad is None else None
        if depth_pad is None:
            depth_pad = pad if sg is None else 0
        if self.padding == "down":
            x = F.pad(x, (0, 1, 0, 1, 0, 0 if sg is not None else 1))
            if sg is not None:
                x = halo_exchange(x, sg, lo=0, hi=1)
        elif sg is not None:
            x = halo_exchange(x, sg, lo=pad, hi=pad)
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride, padding=(depth_pad, pad, pad))


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


def _group_sums(s1: torch.Tensor, s2: torch.Tensor, sg) -> tuple[torch.Tensor, torch.Tensor]:
    """Two (B, G) fp32 sums over the spatial group (one all-reduce)."""
    both = sg.all_reduce_(torch.stack([s1, s2]))
    return both[0], both[1]


def _gn_count(x: torch.Tensor, g: int, sg) -> float:
    """Voxels x channels of one group over the whole volume."""
    return float(x[0, 0].numel() * (x.shape[1] // g) * (sg.size if sg is not None else 1))


def _gn_stats(x: torch.Tensor, g: int, eps: float, sg=None) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, inv-std) per (batch, channel), group-combined: per-channel
    sums first (:func:`~ldm3d_torch.ops.groupnorm.gn_sums`), then the tiny
    (B, C) -> (B, G) combine (``ldm3d_tpu/nn/blocks.py:167-198``); with a
    spatial group ``sg`` the (B, G) sums are summed over its slabs and the
    count is the volume's."""
    b, c = x.shape[:2]
    s1c, s2c = gn_sums(x)
    s1 = s1c.reshape(b, g, c // g).sum(-1)
    s2 = s2c.reshape(b, g, c // g).sum(-1)
    if sg is not None:
        s1, s2 = _group_sums(s1, s2, sg)
    count = _gn_count(x, g, sg)
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
    volume.

    With a spatial group ``sg`` (this rank holding a depth slab) S1 and S2
    are sums over the whole volume, so they are summed over the group as
    the forward's statistics are, and N is the volume's count; dscale and
    dbias stay this slab's sums (the step sums the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x, weight, bias, g: int, eps: float, sg=None):
        mean_c, inv_c = _gn_stats(x, g, eps, sg)
        a_c = inv_c * weight[None, :]
        b_c = bias[None, :] - mean_c * a_c
        ctx.save_for_backward(x, weight, mean_c, inv_c)
        ctx.g, ctx.sg = g, sg
        nd = x.dim()
        return x * _per_channel(a_c, nd).to(x.dtype) + _per_channel(b_c, nd).to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, mean_c, inv_c = ctx.saved_tensors
        g, sg = ctx.g, ctx.sg
        b, c = x.shape[:2]
        n = _gn_count(x, g, sg)
        sum_dy_c, sum_dyx_c = gn_bwd_sums(dy, x, mean_c, inv_c)
        dscale = sum_dyx_c.sum(0)
        dbias = sum_dy_c.sum(0)
        gam = weight[None, :]
        s1 = (sum_dy_c * gam).reshape(b, g, c // g).sum(-1)
        s2 = (sum_dyx_c * gam).reshape(b, g, c // g).sum(-1)
        if sg is not None:
            s1, s2 = _group_sums(s1, s2, sg)
        s1_c = s1.repeat_interleave(c // g, dim=1)
        s2_c = s2.repeat_interleave(c // g, dim=1)
        a1 = inv_c * gam
        a2 = -(inv_c * inv_c) * s2_c / n
        a3 = -inv_c * s1_c / n + mean_c * (inv_c * inv_c) * s2_c / n
        nd, od = x.dim(), x.dtype
        dx = (dy * _per_channel(a1, nd).to(od) + x * _per_channel(a2, nd).to(od)
              + _per_channel(a3, nd).to(od))
        return dx, dscale, dbias, None, None, None


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics regardless of the compute dtype.

    Per-(batch, channel) fp32 sums (the GroupNorm-sums kernel on the card),
    combined per group; var = E[x^2] - mean^2 clamped at 0; the affine is
    folded into one per-channel multiply-add applied in the compute dtype
    (``ldm3d_tpu/nn/blocks.py:167-261``); the backward is
    :class:`GroupNormAffine`'s closed form, over the volume's slabs with a
    ``spatial_group``."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 spatial_group=None):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by {num_groups} groups")
        self.num_groups, self.eps = num_groups, eps
        self.spatial_group = spatial_group
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return GroupNormAffine.apply(x, self.weight, self.bias, self.num_groups, self.eps,
                                     self.spatial_group)


# the outputs JAX's "convs" policy keeps (the ``resblock_conv`` tags: conv1,
# conv2 and the shortcut of a ResBlock) are the block's convolutions
_CONV_OPS = frozenset({torch.ops.aten.convolution.default})


def _save_convs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _CONV_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _convs_context():
    return create_selective_checkpoint_contexts(_save_convs)


def check_remat(remat):
    """The checkpoint context of a remat mode: None for no remat (``False``,
    ``None``), every activation recomputed for ``True``/``"full"``, only the
    convolutions' outputs kept for ``"convs"``; any other value raises
    ``ValueError`` with JAX's message."""
    if not remat:
        return None
    if remat == "convs":
        return _convs_context
    if remat is not True and remat != "full":
        raise ValueError(f"remat must be False, True/'full', or 'convs': {remat!r}")
    return noop_context_fn


def remat_wrapped(block: Callable, remat) -> Callable:
    """``block`` as it runs under a remat mode (``ldm3d_tpu/nn/blocks.py``
    ``remat_wrapped``): ``False``/``None`` is the block itself;
    ``True``/``"full"`` runs it under ``torch.utils.checkpoint`` (non-reentrant),
    which keeps only its inputs and reruns its forward in the backward;
    ``"convs"`` adds a selective policy that keeps the convolutions' outputs
    and recomputes every other op.

    The GroupNorm and attention Functions launch their kernels through
    ``ctypes``, which no policy sees: their forwards rerun in the backward
    under either mode, and what they save (x, weight, mean, inv; q, k, v, O,
    LSE) is what the rerun computes. Without autograd (sampling, validation)
    the block runs as it is."""
    context_fn = check_remat(remat)
    if context_fn is None:
        return block

    def run(*args):
        if not torch.is_grad_enabled():
            return block(*args)
        # the blocks draw no random numbers: no RNG state to stash and restore
        return checkpoint(block, *args, use_reentrant=False, context_fn=context_fn,
                          preserve_rng_state=False)

    return run


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
    channel axis splits as channel = head * head_dim + j. With a
    ``spatial_group`` the queries stay this slab's and the keys and values
    are gathered from every slab (``ldm3d_tpu/nn/blocks.py:413-415``)."""

    def __init__(self, channels: int, num_head_channels: int = 0, num_groups: int = 32,
                 norm_eps: float = 1e-6, spatial_group=None):
        super().__init__()
        self.spatial_group = spatial_group
        self.heads = max(1, channels // num_head_channels) if num_head_channels else 1
        self.norm = GroupNorm32(channels, num_groups, norm_eps)
        self.qkv = Dense(channels, 3 * channels)
        self.proj = Dense(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, d, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2)          # (B, N, C), N in (D, H, W) order
        qkv = self.qkv(y)
        q, k, v = (t.unflatten(-1, (self.heads, c // self.heads)) for t in qkv.chunk(3, dim=-1))
        if self.spatial_group is not None:  # every slab's tokens, in depth order
            k, v = gather_tokens(k, self.spatial_group), gather_tokens(v, self.spatial_group)
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
    ``_upsample_conv_fused`` computes the same sums reassociated.

    With a ``spatial_group`` the halo is taken before the upsample, one row
    of each neighbour's slab (JAX's polyphase choice, ``:495-547``): the x2
    upsample makes it two rows, the conv runs without depth padding, and one
    row at each end is cropped, which leaves this slab's rows exact without
    the 8x volume's halo."""

    def __init__(self, in_channels: int, out_channels: int, spatial_group=None):
        super().__init__()
        self.spatial_group = spatial_group
        self.conv = _conv3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sg = self.spatial_group
        if sg is not None:
            x = halo_exchange(x, sg, lo=1, hi=1)
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = x.contiguous(memory_format=torch.channels_last_3d)
        if sg is None:
            return self.conv(x)
        y = self.conv(x, depth_pad=0)
        return y[:, :, 1:-1].contiguous(memory_format=torch.channels_last_3d)


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
