"""Low-fidelity conditioning encoder.

Counterpart of ``tpuflow/models/lf_encoder.py``: a conv trunk at LF
resolution, then per Glow scale a bilinear resize to that scale's grid
and a conv head. ``jax.image.resize(..., "bilinear")`` antialiases when
it downsamples, so its counterpart is ``F.interpolate(...,
mode="bilinear", antialias=True)``; without ``antialias`` the
downsampled features differ by up to ~0.9.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuflow_torch.flows.layout import LayoutConv


class LFEncoder(nn.Module):
    """LF field (B, h_lf, w_lf, C) -> per-scale features
    [(B, H_l, W_l, width), ...] in the net dtype."""

    def __init__(
        self,
        in_channels: int,
        scale_shapes: Sequence[tuple[int, int]],
        *,
        width: int = 32,
        trunk_layers: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | None = None,
    ):
        super().__init__()
        self.scale_shapes = [tuple(s) for s in scale_shapes]
        self.trunk_layers = trunk_layers
        for i in range(trunk_layers):
            cin = in_channels if i == 0 else width
            self.add_module(f"trunk_{i}", LayoutConv(cin, width, 3, dtype=dtype, device=device))
        for l in range(len(self.scale_shapes)):
            self.add_module(f"head_{l}", LayoutConv(width, width, 3, dtype=dtype, device=device))
        self.dtype = dtype

    def forward(self, lf: torch.Tensor) -> list[torch.Tensor]:
        h = lf
        for i in range(self.trunk_layers):
            h = torch.relu(getattr(self, f"trunk_{i}")(h))
        feats = []
        for l, (th, tw) in enumerate(self.scale_shapes):
            g = F.interpolate(
                h.float().permute(0, 3, 1, 2), size=(th, tw), mode="bilinear",
                align_corners=False, antialias=True,
            ).permute(0, 2, 3, 1)
            feats.append(torch.relu(getattr(self, f"head_{l}")(g)))
        return feats
