"""Diagonal-Gaussian prior helpers for split latents and the base prior.

Counterpart of ``tpuflow/flows/prior.py``. Log-densities are float32
whatever the networks' dtype.
"""

from __future__ import annotations

import math

import torch

_LOG2PI = math.log(2.0 * math.pi)


def gaussian_logp(
    z: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor
) -> torch.Tensor:
    """Diagonal-Gaussian log-density summed over the field axes (H, W, C)
    of NHWC tensors; the batch shape passes through."""
    z, mean, log_std = z.float(), mean.float(), log_std.float()
    lp = -0.5 * (_LOG2PI + 2.0 * log_std + torch.exp(-2.0 * log_std) * (z - mean) ** 2)
    return lp.sum(dim=(-3, -2, -1))


def gaussian_sample(
    mean: torch.Tensor,
    log_std: torch.Tensor,
    temperature: float | torch.Tensor = 1.0,
    z_clip: float = 0.0,
    *,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
) -> torch.Tensor:
    """z = mean + exp(log_std) * temperature * eps with eps standard
    normal, clipped to ±z_clip when z_clip > 0 (clamped, not
    resampled).

    ``eps`` hands in the standard-normal draw (before the clip) instead
    of drawing it from ``generator``: torch cannot reproduce the JAX
    PRNG, so parity tests feed both packages the same draws.
    """
    if eps is None:
        eps = torch.randn(
            mean.shape, generator=generator, device=mean.device, dtype=torch.float32
        )
    elif eps.shape != mean.shape:
        raise ValueError(f"eps shape {tuple(eps.shape)} != {tuple(mean.shape)}")
    eps = eps.float()
    if z_clip > 0.0:
        eps = torch.clamp(eps, -z_clip, z_clip)
    return mean + torch.exp(log_std) * temperature * eps
