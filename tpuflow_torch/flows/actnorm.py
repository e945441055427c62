"""ActNorm: per-channel affine with data-dependent initialisation.

Counterpart of ``tpuflow/flows/actnorm.py``: y = (x + bias) *
exp(log_scale), logdet = H*W*sum(log_scale). :meth:`ActNorm.data_init`
sets the parameters from a batch, as the JAX package's parameter
initializers do inside ``model.init``: bias = -mean, log_scale =
clip(-log(std + 1e-6), -7, 7), with the standard deviation at ddof 0
(``jnp.std``), both over every non-channel axis. ``TMGlow.data_init``
arms every layer (``init_pending``) and runs one forward on a real
batch, so that each layer initialises from its own input in order. The
``initialized`` buffer records it and is saved with the parameters; the
forward never reads it (that would wait for the device on every call).
"""

from __future__ import annotations

import torch
from torch import nn


class ActNorm(nn.Module):
    eps = 1e-6

    def __init__(self, channels: int, *, device: torch.device | None = None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.log_scale = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool, device=device))
        # Set by TMGlow.data_init: the next forward call initialises.
        self.init_pending = False

    @torch.no_grad()
    def data_init(self, x: torch.Tensor) -> None:
        """Set bias and log_scale from the batch ``x`` (..., C) and mark
        the layer initialised."""
        x32 = x.float()
        axes = tuple(range(x.dim() - 1))
        std = x32.std(dim=axes, correction=0)
        self.bias.copy_(-x32.mean(dim=axes))
        self.log_scale.copy_(torch.clamp(-torch.log(std + self.eps), -7.0, 7.0))
        self.initialized.fill_(True)
        self.init_pending = False

    def forward(
        self, x: torch.Tensor, *, reverse: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (N, H, W, C) -> (y f32, logdet (N,) f32; negated in reverse)."""
        if self.init_pending and not reverse:
            self.data_init(x)
        n, h, w, _ = x.shape
        logdet = (h * w * self.log_scale.sum()).expand(n)
        x32 = x.float()
        if reverse:
            return x32 * torch.exp(-self.log_scale) - self.bias, -logdet
        return (x32 + self.bias) * torch.exp(self.log_scale), logdet
