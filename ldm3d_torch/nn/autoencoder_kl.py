"""KL-regularised 3D convolutional autoencoder (stage 1 of the LDM).

Counterpart of ``ldm3d_tpu/nn/autoencoder_kl.py``: GroupNorm + SiLU
ResBlocks, self-attention at the configured levels (one head over all
channels), separate 1x1 quant convs for (mu, log_sigma), and the stage-2
contract ``encode_stage_2_inputs`` / ``decode_stage_2_outputs``; the call
itself (``forward``) is stage 1's encode -> sample -> decode.

Public functions take and return NDHWC. The posterior noise of
``encode_stage_2_inputs`` and of the call is an argument: the caller draws it.

``remat`` (False, True/``"full"`` or ``"convs"``) runs the encoder's and the
decoder's level ResBlocks under :func:`~ldm3d_torch.nn.blocks.remat_wrapped`,
as JAX wraps them; the attention blocks and the non-local mid blocks run as
they are. Setting ``AutoencoderKL.remat`` sets both halves.
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
    ResBlock3D,
    Upsample3D,
    _conv3,
    check_remat,
    remat_wrapped,
    to_channels_last,
)

__all__ = ["AutoencoderKL", "Encoder3D", "Decoder3D"]


class _Stack(nn.Module):
    """Named blocks run in order (the Flax names become the state_dict keys);
    the blocks added with ``remat=True`` run under the stack's ``remat``."""

    def __init__(self, remat=False):
        super().__init__()
        check_remat(remat)
        self.remat = remat
        self._order: list[tuple[str, bool]] = []

    def _add(self, name: str, module: nn.Module, remat: bool = False) -> None:
        self.add_module(name, module)
        self._order.append((name, remat))

    def _run(self, h: torch.Tensor) -> torch.Tensor:
        for name, remat in self._order:
            block = getattr(self, name)
            h = (remat_wrapped(block, self.remat) if remat else block)(h)
        return h


def _mid(stack: _Stack, ch: int, g: int, eps: float) -> None:
    stack._add("mid_res_1", ResBlock3D(ch, ch, g, eps))
    stack._add("mid_attn", AttentionBlock3D(ch, 0, g, eps))
    stack._add("mid_res_2", ResBlock3D(ch, ch, g, eps))


class Encoder3D(_Stack):
    def __init__(self, in_channels: int, channels: Sequence[int], latent_channels: int,
                 num_res_blocks: Sequence[int], attention_levels: Sequence[bool],
                 num_groups: int = 32, norm_eps: float = 1e-6, with_nonlocal_attn: bool = False,
                 remat=False):
        super().__init__(remat)
        g, eps = num_groups, norm_eps
        self._add("conv_in", _conv3(in_channels, channels[0]))
        ch = channels[0]
        levels = len(channels)
        for level in range(levels):
            for block in range(num_res_blocks[level]):
                self._add(f"down_{level}_res_{block}", ResBlock3D(ch, channels[level], g, eps),
                          remat=True)
                ch = channels[level]
                if attention_levels[level]:
                    self._add(f"down_{level}_attn_{block}", AttentionBlock3D(ch, 0, g, eps))
            if level < levels - 1:
                self._add(f"down_{level}_downsample", Downsample3D(ch, ch))
        if with_nonlocal_attn:
            _mid(self, ch, g, eps)
        self.norm_out = GroupNorm32(ch, g, eps)
        self.conv_out = _conv3(ch, latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(F.silu(self.norm_out(self._run(x))))


class Decoder3D(_Stack):
    def __init__(self, channels: Sequence[int], latent_channels: int, out_channels: int,
                 num_res_blocks: Sequence[int], attention_levels: Sequence[bool],
                 num_groups: int = 32, norm_eps: float = 1e-6, with_nonlocal_attn: bool = False,
                 remat=False):
        super().__init__(remat)
        g, eps = num_groups, norm_eps
        rev_channels = list(reversed(channels))
        rev_blocks = list(reversed(num_res_blocks))
        rev_attn = list(reversed(attention_levels))
        self._add("conv_in", _conv3(latent_channels, rev_channels[0]))
        ch = rev_channels[0]
        if with_nonlocal_attn:
            _mid(self, ch, g, eps)
        levels = len(rev_channels)
        for level in range(levels):
            for block in range(rev_blocks[level]):
                self._add(f"up_{level}_res_{block}", ResBlock3D(ch, rev_channels[level], g, eps),
                          remat=True)
                ch = rev_channels[level]
                if rev_attn[level]:
                    self._add(f"up_{level}_attn_{block}", AttentionBlock3D(ch, 0, g, eps))
            if level < levels - 1:
                self._add(f"up_{level}_upsample", Upsample3D(ch, ch))
        self.norm_out = GroupNorm32(ch, g, eps)
        self.conv_out = _conv3(ch, out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.conv_out(F.silu(self.norm_out(self._run(z))))


class AutoencoderKL(nn.Module):
    """3D VAE with a KL prior."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        latent_channels: int = 16,
        channels: Sequence[int] = (64, 128, 256),
        num_res_blocks: Sequence[int] = (2, 2, 2),
        attention_levels: Sequence[bool] = (False, False, True),
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        with_encoder_nonlocal_attn: bool = False,
        with_decoder_nonlocal_attn: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        remat=False,
    ):
        super().__init__()
        self.latent_channels = latent_channels
        self.channels = tuple(channels)
        self.compute_dtype = compute_dtype
        common = dict(num_res_blocks=tuple(num_res_blocks),
                      attention_levels=tuple(attention_levels),
                      num_groups=norm_num_groups, norm_eps=norm_eps, remat=remat)
        self.encoder = Encoder3D(in_channels, channels, latent_channels,
                                 with_nonlocal_attn=with_encoder_nonlocal_attn, **common)
        self.decoder = Decoder3D(channels, latent_channels, out_channels,
                                 with_nonlocal_attn=with_decoder_nonlocal_attn, **common)
        self.quant_conv_mu = _conv3(latent_channels, latent_channels, kernel=1)
        self.quant_conv_log_sigma = _conv3(latent_channels, latent_channels, kernel=1)
        self.post_quant_conv = _conv3(latent_channels, latent_channels, kernel=1)

    @classmethod
    def from_config(cls, **kw) -> "AutoencoderKL":
        """Build from the reference's config keyword surface
        (``config_train_32g.json:7-28``); unknown keys are ignored."""
        if kw.pop("spatial_dims", 3) != 3:
            raise ValueError("ldm3d_torch targets spatial_dims=3")
        channels = tuple(kw.pop("channels", (64, 128, 256)))
        num_res_blocks = kw.pop("num_res_blocks", 2)
        if isinstance(num_res_blocks, int):
            num_res_blocks = (num_res_blocks,) * len(channels)
        dtype = kw.pop("dtype", torch.float32)
        return cls(
            in_channels=kw.pop("in_channels", 1),
            out_channels=kw.pop("out_channels", 1),
            latent_channels=kw.pop("latent_channels", 16),
            channels=channels,
            num_res_blocks=tuple(num_res_blocks),
            attention_levels=tuple(kw.pop("attention_levels", (False, False, True))),
            norm_num_groups=kw.pop("norm_num_groups", 32),
            norm_eps=kw.pop("norm_eps", 1e-6),
            with_encoder_nonlocal_attn=kw.pop("with_encoder_nonlocal_attn", False),
            with_decoder_nonlocal_attn=kw.pop("with_decoder_nonlocal_attn", False),
            compute_dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
            remat=kw.pop("remat", False),
        )

    @property
    def remat(self):
        return self.encoder.remat

    @remat.setter
    def remat(self, value) -> None:
        check_remat(value)
        self.encoder.remat = self.decoder.remat = value

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.channels) - 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """NDHWC image -> NDHWC ``(z_mu, z_sigma)`` in the compute dtype; the
        log-variance is clamped to [-30, 20] in fp32."""
        h = self.encoder(to_channels_last(x.to(self.compute_dtype)))
        z_mu = self.quant_conv_mu(h)
        z_log_var = torch.clamp(self.quant_conv_log_sigma(h).float(), -30.0, 20.0)
        z_sigma = torch.exp(0.5 * z_log_var).to(self.compute_dtype)
        return z_mu.permute(0, 2, 3, 4, 1), z_sigma.permute(0, 2, 3, 4, 1)

    def encode_stage_2_inputs(self, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Posterior sample ``z_mu + z_sigma * eps``; ``eps`` is the caller's
        standard-normal noise of the latent's NDHWC shape."""
        z_mu, z_sigma = self.encode(x)
        return z_mu + z_sigma * eps.to(z_mu.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """NDHWC latent -> NDHWC image in the compute dtype."""
        h = self.post_quant_conv(to_channels_last(z.to(self.compute_dtype)))
        return self.decoder(h).permute(0, 2, 3, 4, 1)

    def decode_stage_2_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)

    def forward(self, x: torch.Tensor,
                eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Encode, sample the posterior with the caller's standard-normal
        ``eps`` (the latent's NDHWC shape), decode: ``(recon, z_mu,
        z_sigma)``, NDHWC, the stage-1 training call."""
        z_mu, z_sigma = self.encode(x)
        recon = self.decode(z_mu + z_sigma * eps.to(z_mu.dtype))
        return recon, z_mu, z_sigma
