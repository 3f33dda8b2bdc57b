"""2.5D perceptual (LPIPS-SqueezeNet) loss of the stage-1 trainer.

The port of ``ldm3d_tpu/nn/lpips.py`` (MONAI's ``PerceptualLoss(spatial_dims=3,
network_type="squeeze", is_fake_3d=True, fake_3d_ratio=0.2)``): a 3D volume
is scored by a 2D LPIPS network on a random subset of slices along each
axis, and the three axes' losses are averaged.

The trunk is SqueezeNet v1.1 with the 7 LPIPS feature stages. Its public
functions take NHWC images, as the JAX module does; inside it runs NCHW
views of them. Pretrained weights are a download and are not used: the
trunk and the ``lin_{i}`` channel weights take a fixed-seed initialisation
(:data:`LPIPS_SEED`), or the weights the caller loads (the stage-1 CLI's
``lpips_weights``). The slice indices are an argument: the caller passes
them, or draws them with :func:`draw_slices` from its ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LPIPS", "LPIPS_SEED", "SqueezeNetFeatures", "draw_slices", "init_lpips_",
           "perceptual_loss_25d"]

# the seed of the fixed initialisation of the port's LPIPS (init_lpips_)
LPIPS_SEED = 17
# channel widths of the 7 LPIPS-squeeze feature stages
_SQUEEZE_STAGE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
# LPIPS input standardisation
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Conv2D(nn.Module):
    """2D convolution, weight ``(O, I, k, k)``; ``pad`` on every side."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1,
                 pad: int = 0):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight[0].numel()), generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=self.stride,
                        padding=self.pad)


class _Fire(nn.Module):
    def __init__(self, in_channels: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = _Conv2D(in_channels, squeeze, 1)
        self.expand1 = _Conv2D(squeeze, expand, 1)
        self.expand3 = _Conv2D(squeeze, expand, 3, pad=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return F.relu(torch.cat([self.expand1(s), self.expand3(s)], dim=1))


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, stride=2, ceil_mode=True)`` as the JAX module
    computes it on NCHW: the right and bottom padded with -inf to
    ``(out - 1) * 2 + 3`` with ``out = ceil((n - 3) / 2) + 1`` floored at 1,
    then a VALID pool. A map of 1 or 2 pixels, which torch refuses, gives 1."""
    pads = []
    for n in (x.shape[2], x.shape[3]):
        out = max(1, -((3 - n) // 2) + 1)
        pads.append(max(0, (out - 1) * 2 + 3 - n))
    if any(pads):
        x = F.pad(x, (0, pads[1], 0, pads[0]), value=-math.inf)
    return F.max_pool2d(x, kernel_size=3, stride=2)


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet v1.1 trunk: NCHW in, the 7 LPIPS feature stages out."""

    def __init__(self):
        super().__init__()
        # torchvision squeezenet1_1 features[0]: Conv2d(3, 64, 3, stride=2), no padding
        self.conv1 = _Conv2D(3, 64, 3, stride=2)
        widths = (("fire2", 64, 16, 64), ("fire3", 128, 16, 64), ("fire4", 128, 32, 128),
                  ("fire5", 256, 32, 128), ("fire6", 256, 48, 192), ("fire7", 384, 48, 192),
                  ("fire8", 384, 64, 256), ("fire9", 512, 64, 256))
        for name, cin, squeeze, expand in widths:
            self.add_module(name, _Fire(cin, squeeze, expand))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.relu(self.conv1(x))
        feats = [h]                                                   # stage 1
        h = self.fire3(self.fire2(_maxpool(h)))
        feats.append(h)                                               # stage 2
        h = self.fire5(self.fire4(_maxpool(h)))
        feats.append(h)                                               # stage 3
        h = self.fire6(_maxpool(h))
        feats.append(h)                                               # stage 4
        for name in ("fire7", "fire8", "fire9"):                      # stages 5-7
            h = getattr(self, name)(h)
            feats.append(h)
        return feats


class LPIPS(nn.Module):
    """LPIPS distance between batches of 2D images ``(B, H, W, C<=3)`` in
    [0, 1]: ``(B,)`` fp32. The trunk computes in ``compute_dtype``; the
    distance is fp32."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.squeeze = SqueezeNetFeatures()
        for i, c in enumerate(_SQUEEZE_STAGE_CHANNELS):
            self.register_parameter(f"lin_{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def _prep(self, img: torch.Tensor) -> torch.Tensor:
        """NHWC in [0, 1] -> NCHW, 3 channels, [-1, 1], channel-standardised."""
        img = img.permute(0, 3, 1, 2).float()
        if img.shape[1] == 1:
            img = img.expand(-1, 3, -1, -1)
        return ((img * 2.0 - 1.0 - self.shift) / self.scale).to(self.compute_dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.squeeze(self._prep(x))
        fy = self.squeeze(self._prep(y))
        total = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
        for i, (a, b) in enumerate(zip(fx, fy)):
            a32, b32 = a.float(), b.float()
            # lpips normalize_tensor: feat / (||feat||_2 + 1e-10) over the channels
            a_n = a32 / (torch.sqrt(torch.sum(a32 * a32, dim=1, keepdim=True)) + 1e-10)
            b_n = b32 / (torch.sqrt(torch.sum(b32 * b32, dim=1, keepdim=True)) + 1e-10)
            diff = (a_n - b_n) ** 2
            w = F.relu(getattr(self, f"lin_{i}")).reshape(1, -1, 1, 1)
            # lpips "lin" layer: a non-negative 1x1 conv, then the spatial mean
            total = total + torch.mean(torch.sum(diff * w, dim=1), dim=(1, 2))
        return total


def init_lpips_(lpips: LPIPS, generator: torch.Generator | None = None) -> LPIPS:
    """The port's fixed initialisation: lecun-normal conv kernels and zero
    biases drawn from ``generator`` (by default a CPU generator seeded with
    :data:`LPIPS_SEED`), unit ``lin_{i}``."""
    if generator is None:
        generator = torch.Generator().manual_seed(LPIPS_SEED)
    for m in lpips.modules():
        if isinstance(m, _Conv2D):
            m.reset_parameters(generator)
    with torch.no_grad():
        for i in range(len(_SQUEEZE_STAGE_CHANNELS)):
            getattr(lpips, f"lin_{i}").fill_(1.0)
    return lpips


def _slices_along_axis(vol: torch.Tensor, axis: int, idx: torch.Tensor) -> torch.Tensor:
    """Slices ``idx`` of a ``(B, D, H, W, C)`` volume along spatial ``axis``
    -> ``(B * K, h, w, C)``."""
    vol = torch.movedim(vol, 1 + axis, 1)
    sl = torch.index_select(vol, 1, idx.to(vol.device))
    return sl.reshape(sl.shape[0] * sl.shape[1], *sl.shape[2:])


def draw_slices(generator: torch.Generator, shape: Sequence[int],
                fake_3d_ratio: float = 0.2) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each spatial axis of a ``(B, D, H, W, C)`` volume, ``ceil(ratio *
    n)`` (at least 1) distinct slice indices, drawn as ``randperm(n)[:k]``
    on the generator's device."""
    out = []
    for axis in range(3):
        n = shape[1 + axis]
        k = max(1, math.ceil(fake_3d_ratio * n))
        out.append(torch.randperm(n, generator=generator, device=generator.device)[:k])
    return tuple(out)


def perceptual_loss_25d(lpips, x: torch.Tensor, y: torch.Tensor,
                        idx: Sequence[torch.Tensor]) -> torch.Tensor:
    """2.5D perceptual loss between ``(B, D, H, W, C)`` volumes: for each axis
    the mean LPIPS distance of the slices ``idx[axis]``, then the mean of the
    three."""
    losses = [torch.mean(lpips(_slices_along_axis(x, axis, idx[axis]),
                               _slices_along_axis(y, axis, idx[axis]))) for axis in range(3)]
    return torch.mean(torch.stack(losses))
