"""Squeeze / unsqueeze: volume-preserving space-to-depth between scales.

Counterpart of ``tpuflow/flows/squeeze.py`` (nhwc): H and W halve, C
quadruples, logdet = 0. The channel packing order is ``(fh fw c)``,
which ``F.pixel_unshuffle`` does not give (it packs ``(c fh fw)``), so
the reshape and permute are written out.
"""

from __future__ import annotations

import torch


def squeeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/f, W/f, C*f*f), channels packed (fh fw c)."""
    *lead, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"spatial shape {(h, w)} not divisible by {factor}")
    n = len(lead)
    x = x.reshape(*lead, h // factor, factor, w // factor, factor, c)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h // factor, w // factor, factor * factor * c)


def unsqueeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Exact inverse of :func:`squeeze2d`."""
    *lead, h, w, cf = x.shape
    c = cf // (factor * factor)
    n = len(lead)
    x = x.reshape(*lead, h, w, factor, factor, c)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h * factor, w * factor, c)
