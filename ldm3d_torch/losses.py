"""Stage-2 loss: the port's copy of ``l2_loss`` from ``ldm3d_tpu/losses/losses.py``
(fp32 accumulation, torch ``MSELoss`` parity)."""

from __future__ import annotations

import torch

__all__ = ["l2_loss"]


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    diff = pred.float() - target.float()
    return torch.mean(diff * diff)
