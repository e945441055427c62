"""NHWC convolution, the counterpart of ``tpuflow/flows/layout.py``'s
``LayoutConv`` under ``layout="nhwc"``.

Flow tensors are (N, H, W, C) at every public function, as in the JAX
package. A convolution views them as NCHW in channels-last memory
(``permute`` is free) and hands the result back as NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    dtype: torch.dtype,
) -> torch.Tensor:
    """SAME, stride-1 conv of a (N, H, W, Cin) tensor with an OIHW
    weight, computed in ``dtype``; the bias is added in ``dtype`` after
    the conv, as the JAX package's convs do. Returns (N, H, W, Cout)."""
    if x.dim() != 4:
        raise ValueError(f"conv_nhwc expects a 4-D tensor, got shape {tuple(x.shape)}")
    y = F.conv2d(
        x.to(dtype).permute(0, 3, 1, 2),
        weight.to(dtype),
        padding=weight.shape[-1] // 2,
    ).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal`` for an OIHW kernel: a normal truncated at
    ±2 standard deviations, scaled to variance 1/fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        t = torch.empty(w.shape, dtype=torch.float32)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.copy_(t * std)
    return w


class LayoutConv(nn.Module):
    """kxk SAME conv over NHWC tensors with Flax ``nn.Conv``'s
    parameters (``weight`` OIHW f32, optional ``bias``), computed in
    ``dtype``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 3,
        *,
        use_bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(features, in_features, kernel_size, kernel_size, device=device)
        )
        self.bias = (
            nn.Parameter(torch.zeros(features, device=device)) if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x, self.weight, self.bias, self.dtype)
