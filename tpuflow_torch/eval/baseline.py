"""Trivial-baseline comparator: bicubic LF -> HF upsampling.

Counterpart of ``tpuflow/eval/baseline.py``. The evaluator reports the
bicubic-upsampled LF trajectory on the same metrics as the model, so the
model's skill over the cheap alternative is a number. The baseline is
deterministic: its fluctuation statistics come from the time axis only,
like the HF reference's.

``jax.image.resize(..., "cubic")`` is Keys' kernel with a = -0.5 over the
input pixels only, each output's weights renormalized to sum to 1 at the
borders. ``F.interpolate(mode="bicubic")`` uses a = -0.75 and replicates
edge pixels, so the resize is written here as JAX computes it: one
(in, out) weight matrix per resized axis, contracted in float32.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def cubic_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of an upsampling cubic resize along one axis,
    as ``jax.image.scale.compute_weight_mat`` builds them."""
    inv_scale = 1.0 / (n_out / n_in)
    sample_f = (torch.arange(n_out, dtype=F32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=F32, device=device)[:, None]).abs()
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def lf_upsample(lf_phys: torch.Tensor, hf_shape: tuple[int, int]) -> torch.Tensor:
    """Bicubic upsampling of a physical-unit LF trajectory (T, lh, lw, C)
    to the HF grid: (T, H, W, C) float32."""
    x = lf_phys.to(F32)
    _, lh, lw, _ = x.shape
    if (lh, lw) != tuple(hf_shape):
        wy = cubic_weights(lh, hf_shape[0], x.device)
        wx = cubic_weights(lw, hf_shape[1], x.device)
        x = torch.einsum("tywc,yY,wX->tYXc", x, wy, wx)
    return x


def skill(model_err: float, baseline_err: float) -> float:
    """Skill ratio > 1 means the model beats the trivial baseline on this
    (lower-is-better) error metric."""
    return float(baseline_err) / (float(model_err) + 1e-12)
