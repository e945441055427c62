"""ActNorm: per-channel affine, forward and reverse apply.

Counterpart of ``tpuflow/flows/actnorm.py``: y = (x + bias) *
exp(log_scale), logdet = H*W*sum(log_scale). The data-dependent
initialisation belongs to training and is not ported yet: parameters
start at the identity (zeros) and are loaded from a checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn


class ActNorm(nn.Module):
    def __init__(self, channels: int, *, device: torch.device | None = None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.log_scale = nn.Parameter(torch.zeros(channels, device=device))

    def forward(
        self, x: torch.Tensor, *, reverse: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (N, H, W, C) -> (y f32, logdet (N,) f32; negated in reverse)."""
        n, h, w, _ = x.shape
        logdet = (h * w * self.log_scale.sum()).expand(n)
        x32 = x.float()
        if reverse:
            return x32 * torch.exp(-self.log_scale) - self.bias, -logdet
        return (x32 + self.bias) * torch.exp(self.log_scale), logdet
