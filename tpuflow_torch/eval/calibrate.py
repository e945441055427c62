"""Post-hoc UQ recalibration: spread scaling, per-location spread fields,
per-level interval scales, variance-statistic factors, quantile maps
(pooled, LF-conditioned, streamwise-stratified) and a radial spectral
filter.

Counterpart of ``tpuflow/eval/calibrate.py``; the fits and their
rationale are documented there. Every function takes tensors and
computes on their device in float32. The evaluator fits them on one split
of the test trajectories and scores them on the other
(``eval/metrics.py``); the spread factors deploy on the two-moment
rollout stats as ``var * s**2`` (``eval.spread_scale``,
``eval.spread_field``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.eval.stats import gaussian_coverage, interp, interval_z, quantile

F32 = torch.float32


def ensemble_zscores(members: torch.Tensor, ref: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-point z-scores (ref - mean) / std of an ensemble; std with ddof
    0 (the rollout stats' variance) and the 1e-20 floor of the scoring."""
    x = members.movedim(axis, 0)
    if x.shape[0] < 2:
        raise ValueError(f"ensemble_zscores needs >= 2 members (got {x.shape[0]})")
    return (ref - x.mean(dim=0)) / torch.sqrt(x.var(dim=0, correction=0) + 1e-20)


def fit_spread_scale_from_z(z: torch.Tensor) -> torch.Tensor:
    """Spread inflation factor from (pooled) z-scores: s = RMS(z)."""
    return torch.sqrt((z * z).mean())


def fit_variance_scale_from_moments(sq_resid_mean, ens_var_mean, n_members: int) -> torch.Tensor:
    """Member-deviation factor for variance-derived statistics, fit by
    unbiased moment matching: sigma^2 = max(E[r^2] - E[v] / (N-1), 0),
    s^2 = sigma^2 (N-1) / (N E[v]); 1 for a calibrated ensemble at any N."""
    if n_members < 2:
        raise ValueError(f"fit_variance_scale needs >= 2 members, got {n_members}")
    r2 = torch.as_tensor(sq_resid_mean, dtype=F32)
    v = torch.as_tensor(ens_var_mean, dtype=F32) + 1e-20
    sigma2 = torch.clamp(r2 - v / (n_members - 1), min=0.0)
    return torch.sqrt(sigma2 * (n_members - 1) / (n_members * v))


def fit_variance_scale(members: torch.Tensor, ref: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``fit_variance_scale_from_moments`` on raw member fields."""
    x = members.movedim(axis, 0)
    r2 = ((ref - x.mean(dim=0)) ** 2).mean()
    v = x.var(dim=0, correction=0).mean()
    return fit_variance_scale_from_moments(r2, v, x.shape[0])


def _knots(xq: torch.Tensor, n_quantiles: int, span) -> torch.Tensor:
    """Strictly increasing knots: a ramp of 1e-7 * span per knot, then a
    running maximum (ties in masked or constant regions stay invertible)."""
    eps = 1e-7 * span * torch.arange(n_quantiles, dtype=F32, device=xq.device)
    return torch.cummax(xq + eps, dim=-1).values


def fit_quantile_map(pred_vals: torch.Tensor, ref_vals: torch.Tensor,
                     n_quantiles: int = 65) -> tuple[torch.Tensor, torch.Tensor]:
    """CDF-matching map of a pooled marginal: knots (xq, yq) at the
    midpoint probability levels of the predicted and reference samples."""
    p = (torch.arange(n_quantiles, dtype=F32) + 0.5) / n_quantiles
    xq = quantile(pred_vals.reshape(-1).to(F32), p)
    yq = quantile(ref_vals.reshape(-1).to(F32), p)
    return _knots(xq, n_quantiles, xq[-1] - xq[0] + 1.0), yq


def apply_quantile_map(vals: torch.Tensor, xq: torch.Tensor, yq: torch.Tensor) -> torch.Tensor:
    """Apply a fitted quantile map; outside the knots the end segments'
    slopes extend linearly (clamping would flatten the tails)."""
    v = vals.to(F32)
    out = interp(v, xq, yq)
    lo_slope = (yq[1] - yq[0]) / (xq[1] - xq[0])
    hi_slope = (yq[-1] - yq[-2]) / (xq[-1] - xq[-2])
    out = torch.where(v < xq[0], yq[0] + (v - xq[0]) * lo_slope, out)
    return torch.where(v > xq[-1], yq[-1] + (v - xq[-1]) * hi_slope, out)


def _rfft_radius(h: int, w: int, domain, device) -> torch.Tensor:
    ly, lx = float(domain[0]), float(domain[1])
    ky = torch.as_tensor(np.fft.fftfreq(h) * h / ly, dtype=F32, device=device)
    kx = torch.as_tensor(np.fft.rfftfreq(w) * w / lx, dtype=F32, device=device)
    return torch.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)


def fit_spectral_filter(e_model: torch.Tensor, e_ref: torch.Tensor, k_bins: torch.Tensor,
                        cap: float = 1.2) -> tuple[torch.Tensor, torch.Tensor]:
    """Radial filter S(k) = sqrt(E_ref / E_model), clipped to [0, cap],
    S = 1 on the mean mode. Returns (k_bins, s_vals), each (nbins,)."""
    s = torch.sqrt((e_ref + 1e-30) / (e_model + 1e-30)).clamp(0.0, cap)
    s[0] = 1.0
    return k_bins.to(F32), s.to(F32)


def apply_spectral_filter(members: torch.Tensor, k_bins: torch.Tensor, s_vals: torch.Tensor,
                          domain: tuple[float, float]) -> torch.Tensor:
    """Filter the member fluctuations of (N, T, H, W, C) fields about
    their (ensemble x time) mean by S(|k|), interpolated (clamped) from the
    fitted radial profile; the mean passes through."""
    h, w = members.shape[-3], members.shape[-2]
    mean = members.mean(dim=(0, 1), keepdim=True)
    s2d = interp(_rfft_radius(h, w, domain, members.device), k_bins, s_vals)
    x = (members - mean).movedim(-1, 0)
    x_f = torch.fft.irfft2(torch.fft.rfft2(x, dim=(-2, -1)) * s2d, s=(h, w), dim=(-2, -1))
    return mean + x_f.movedim(0, -1)


def fit_lf_conditioned_qmap(pred_parts: list, ref_parts: list, lf_stds: list,
                            n_quantiles: int = 65) -> tuple[torch.Tensor, torch.Tensor, float]:
    """LF-conditioned quantile map: one pooled map between per-trajectory
    self-standardized marginals, and alpha, the mean ratio of each
    trajectory's reference std to its LF fluctuation std. Returns (xq, yq,
    alpha)."""
    pred_std = torch.cat([p.reshape(-1) / (float(p.std(correction=0)) + 1e-12)
                          for p in pred_parts])
    ref_std = torch.cat([r.reshape(-1) / (float(r.std(correction=0)) + 1e-12)
                         for r in ref_parts])
    xq, yq = fit_quantile_map(pred_std, ref_std, n_quantiles)
    ratios = [float(r.std(correction=0)) / (s + 1e-12) for r, s in zip(ref_parts, lf_stds)]
    return xq, yq, float(np.mean(ratios))


def apply_lf_conditioned_qmap(vals: torch.Tensor, sigma_member: float, sigma_lf: float,
                              xq: torch.Tensor, yq: torch.Tensor, alpha: float) -> torch.Tensor:
    """Apply the LF-conditioned map from deploy-time statistics only: the
    ensemble's own fluctuation std and the trajectory's LF one."""
    z = vals / (sigma_member + 1e-12)
    return alpha * sigma_lf * apply_quantile_map(z, xq, yq)


def fit_quantile_map_stratified(pred_vals: torch.Tensor, ref_vals: torch.Tensor,
                                n_quantiles: int = 65) -> tuple[torch.Tensor, torch.Tensor]:
    """One quantile map per stratum (leading index): pred (S, M), ref
    (S, K) -> (xq, yq), each (S, n_quantiles)."""
    p = (torch.arange(n_quantiles, dtype=F32) + 0.5) / n_quantiles
    xq = quantile(pred_vals.to(F32), p, dim=1).T
    yq = quantile(ref_vals.to(F32), p, dim=1).T
    return _knots(xq, n_quantiles, xq[:, -1:] - xq[:, :1] + 1.0), yq


def apply_quantile_map_stratified(vals: torch.Tensor, xq: torch.Tensor,
                                  yq: torch.Tensor) -> torch.Tensor:
    """Apply per-stratum maps to vals (S, ...), stratum axis 0."""
    flat = vals.reshape(vals.shape[0], -1)
    out = torch.stack([apply_quantile_map(v, x, y) for v, x, y in zip(flat, xq, yq)])
    return out.reshape(vals.shape)


def fit_spread_field_from_z(z_stack: torch.Tensor, prior_weight: float = 8.0,
                            clip: tuple[float, float] = (0.25, 6.0)) -> torch.Tensor:
    """Per-location spread factor field from pooled z-score fields (M,
    *field): per-location RMS shrunk toward the global one by
    ``prior_weight`` pseudo-samples, clipped to ``clip``."""
    z2 = z_stack.to(F32) ** 2
    n = z2.shape[0]
    g2 = z2.mean()
    s2 = (z2.sum(dim=0) + prior_weight * g2) / (n + prior_weight)
    return torch.sqrt(s2).clamp(*clip)


def fit_spread_scale(members: torch.Tensor, ref: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Spread inflation factor by z-score moment matching (s > 1: the raw
    ensemble is underdispersed)."""
    return fit_spread_scale_from_z(ensemble_zscores(members, ref, axis))


def scale_members(members: torch.Tensor, scale, axis: int = 0) -> torch.Tensor:
    """mean + scale * (members - mean) over the member axis: the mean is
    kept, the spread scaled (a scalar or a broadcastable field)."""
    mean = members.mean(dim=axis, keepdim=True)
    return mean + scale * (members - mean)


def fit_interval_scales(members: torch.Tensor, ref: torch.Tensor,
                        levels: tuple[float, ...] = (0.5, 0.8, 0.9, 0.95),
                        axis: int = 0) -> torch.Tensor:
    """Per-level interval factors s_q = quantile(|z|, q) / ndtri((1+q)/2),
    which make mean +- s_q ndtri((1+q)/2) std cover q on the fit data."""
    return fit_interval_scales_from_z(ensemble_zscores(members, ref, axis), levels)


def fit_interval_scales_from_z(z: torch.Tensor,
                               levels: tuple[float, ...] = (0.5, 0.8, 0.9, 0.95)) -> torch.Tensor:
    """Per-level factors from (pooled) z-scores."""
    qs = torch.tensor(levels, dtype=F32)
    return quantile(z.abs().reshape(-1), qs) / interval_z(qs).to(z.device)


def scaled_interval_coverage(mean: torch.Tensor, var: torch.Tensor, ref: torch.Tensor,
                             scales, levels: tuple[float, ...] = (0.5, 0.8, 0.9, 0.95)
                             ) -> torch.Tensor:
    """Coverage of the per-level recalibrated two-moment intervals
    mean +- s_q interval_z(q) std."""
    return gaussian_coverage(mean, var, ref, levels, scales=scales)
