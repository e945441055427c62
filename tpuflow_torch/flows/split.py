"""Conditional split with a learned Gaussian prior, and the base prior.

Counterpart of ``tpuflow/flows/split.py``. A zero-initialised 3x3 conv
on the retained half (concatenated with the conditioning features)
predicts the factored latent's mean and log-std, mean first; the
log-std is soft-clamped to ``2*tanh(x/2)``.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuflow_torch.flows.layout import LayoutConv
from tpuflow_torch.flows.prior import gaussian_logp, gaussian_sample


class _PriorNet(nn.Module):
    """Zero-init conv producing (mean, log_std) for ``out_channels``."""

    def __init__(self, in_channels, out_channels, *, dtype, device=None):
        super().__init__()
        self.prior_conv = LayoutConv(
            in_channels, 2 * out_channels, 3, dtype=dtype, device=device
        )

    def forward(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        st = self.prior_conv(h).float()
        mean, log_std = st.chunk(2, dim=-1)
        return mean, 2.0 * torch.tanh(log_std / 2.0)


class ConditionalSplit(nn.Module):
    """forward: z -> (keep, drop, logp(drop | keep, cond));
    reverse: keep -> concat([keep, drop]), drop given or drawn at
    temperature tau."""

    def __init__(self, channels, cond_channels, *, dtype, z_clip=0.0, device=None):
        super().__init__()
        ck = channels // 2
        self.z_clip = z_clip
        self.prior = _PriorNet(ck + cond_channels, channels - ck, dtype=dtype, device=device)

    def _prior(self, keep, cond):
        h = keep if cond is None else torch.cat([keep, cond.to(keep.dtype)], dim=-1)
        return self.prior(h)

    def forward(self, z, cond=None):
        ck = z.shape[-1] // 2
        keep, dropped = z[..., :ck], z[..., ck:]
        mean, log_std = self._prior(keep, cond)
        return keep, dropped, gaussian_logp(dropped, mean, log_std)

    def reverse(
        self, keep, cond=None, *, drop=None, temperature=1.0, generator=None, eps=None
    ):
        mean, log_std = self._prior(keep, cond)
        if drop is None:
            drop = gaussian_sample(
                mean, log_std, temperature, self.z_clip, generator=generator, eps=eps
            )
        out = torch.cat([keep.float(), drop.float()], dim=-1)
        return out, -gaussian_logp(drop, mean, log_std)


class ConditionalPrior(nn.Module):
    """Learned conditional N(mean, std) base prior for the final latent.
    forward: logp(z | cond); reverse: a draw at temperature tau."""

    def __init__(self, channels, cond_channels, *, dtype, z_clip=0.0, device=None):
        super().__init__()
        self.z_clip = z_clip
        self.prior = _PriorNet(cond_channels, channels, dtype=dtype, device=device)

    def forward(self, z, cond):
        mean, log_std = self.prior(cond)
        return z, gaussian_logp(z, mean, log_std)

    def reverse(self, cond, *, temperature=1.0, generator=None, eps=None):
        mean, log_std = self.prior(cond)
        z = gaussian_sample(
            mean, log_std, temperature, self.z_clip, generator=generator, eps=eps
        )
        return z, -gaussian_logp(z, mean, log_std)
