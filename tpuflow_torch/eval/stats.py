"""Physics statistics: TKE, velocity moments, field error norms, energy
spectra, fluctuation PDFs and UQ scores (CRPS, interval coverage).

Counterpart of ``tpuflow/eval/stats.py``. Every function takes tensors and
computes on their device in float32, as the JAX package computes with
x64 off; host-side constants (the Hann window, FFT frequencies, bin
indices) are built in float64 NumPy and cast, as there. Inputs are in
PHYSICAL units: denormalize fields with ``TrajectoryDataset.denorm_hf``
and variances with ``denorm_hf_var``. Channels: [..., 0]=u, 1=v, 2=p.

Library calls with other semantics than the JAX ones, written here by
hand: ``quantile`` (``torch.quantile`` refuses more than 2^24 values),
``histogram`` (``jnp.histogram`` edges and density; ``torch.histogram``
has no CUDA kernel), ``interp`` (``jnp.interp``), ``gradient``
(``jnp.gradient`` with unit spacing). Variances have ddof 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def _axes(axis, ndim: int) -> tuple[int, ...]:
    return tuple(range(ndim)) if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=F32, device=like.device)


def quantile(a: torch.Tensor, q, dim: int | None = None) -> torch.Tensor:
    """``jnp.quantile(a, q, axis=dim)`` with its default "linear" method:
    a sort along ``dim``, then interpolation between the order statistics
    at ``q * (n - 1)``, in float32 as JAX computes it, at any size. A NaN
    along ``dim`` makes that result NaN. ``q`` is a scalar or a 1-D
    sequence; the output has q's axis first, then the reduced shape."""
    if dim is None:
        a, dim = a.reshape(-1), 0
    q = torch.as_tensor(q, dtype=F32, device=a.device)
    x = a.to(F32).movedim(dim, -1)
    x = torch.where(torch.isnan(x).any(-1, keepdim=True), torch.nan, x)
    x = torch.sort(x, dim=-1).values
    # n - 1 in float32, as JAX takes it (inexact above 2^24 values).
    last = float(np.float32(x.shape[-1]) - np.float32(1))
    pos = q * last
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    # JAX's gather clips an index that the inexact n - 1 put past the end.
    low = low.clamp(0, last).long().clamp_max(x.shape[-1] - 1)
    high = high.clamp(0, last).long().clamp_max(x.shape[-1] - 1)
    shape = x.shape[:-1] + q.shape
    low_v = x[..., low.reshape(-1)].reshape(shape)
    high_v = x[..., high.reshape(-1)].reshape(shape)
    out = low_v * low_w + high_v * high_w
    return out.movedim(-1, 0) if q.dim() == 1 else out


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: piecewise-linear, clamped to fp's end
    values outside [xp[0], xp[-1]]."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def histogram(x: torch.Tensor, bins: int, lo: float, hi: float):
    """``jnp.histogram(x, bins, range=(lo, hi), density=True)``: the last
    bin closed on the right, values outside the range dropped. The float32
    edges are JAX's bit for bit, as XLA computes its linspace on the CPU
    (step i * (1 / bins), the last product fused), built on the host and
    uploaded. Returns (density (bins,), edges (bins+1,), counts (bins,)
    int64)."""
    f32 = np.float32
    lo32, hi32 = f32(lo), f32(hi)
    if lo32 == hi32:
        lo32, hi32 = lo32 - f32(0.5), hi32 + f32(0.5)
    step = np.arange(bins, dtype=f32) * (f32(1) / f32(bins))
    e = (lo32 * (f32(1) - step)).astype(np.float64) + np.float64(hi32) * step.astype(np.float64)
    x = x.reshape(-1).to(F32).contiguous()
    edges = _const(np.append(e.astype(f32), hi32), x)
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    c = counts.to(F32)
    density = c / (edges[1:] - edges[:-1]) / c.sum()
    return density, edges, counts


def gradient(f: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient(f, axis=dim)``: central differences inside,
    one-sided at the two edges, unit spacing."""
    n = f.shape[dim]
    sl = lambda a, b: f.narrow(dim, a, b - a)  # noqa: E731
    upper = sl(1, 2) - sl(0, 1)
    lower = sl(n - 1, n) - sl(n - 2, n - 1)
    inner = (sl(2, n) - sl(0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim=dim)


def tke_field(var_uv: torch.Tensor) -> torch.Tensor:
    """k = 1/2 (var_u + var_v) from per-point variances (..., C>=2)."""
    return 0.5 * (var_uv[..., 0] + var_uv[..., 1])


def ensemble_stats(fields: torch.Tensor, axis: int = 0) -> dict[str, torch.Tensor]:
    """Mean and variance (ddof 0) over the ensemble axis."""
    return {"mean": fields.mean(dim=axis), "var": fields.var(dim=axis, correction=0)}


def velocity_moments(fields: torch.Tensor, axes: tuple[int, ...] = (0,)) -> dict:
    """First four central moments of each channel over ``axes``; skew and
    kurtosis divide by powers of var + 1e-12, so degenerate (masked)
    points give 0, not NaN."""
    mean = fields.mean(dim=axes, keepdim=True)
    d = fields - mean
    var = (d**2).mean(dim=axes)
    eps = 1e-12
    return {
        "mean": mean.squeeze(axes),
        "var": var,
        "skew": (d**3).mean(dim=axes) / (var + eps) ** 1.5,
        "kurt": (d**4).mean(dim=axes) / (var + eps) ** 2,
    }


def reynolds_stress_uv(fields: torch.Tensor, axes: tuple[int, ...] = (0,)) -> torch.Tensor:
    """Reynolds shear stress <u'v'> over ``axes``."""
    u, v = fields[..., 0], fields[..., 1]
    du = u - u.mean(dim=axes, keepdim=True)
    dv = v - v.mean(dim=axes, keepdim=True)
    return (du * dv).mean(dim=axes)


def vorticity(fields: torch.Tensor, dx: float = 1.0, dy: float = 1.0) -> torch.Tensor:
    """w = dv/dx - du/dy of (..., H, W, C>=2) fields (rows y, columns x),
    central differences with the physical spacings."""
    return gradient(fields[..., 1], -1) / dx - gradient(fields[..., 0], -2) / dy


def divergence(fields: torch.Tensor, dx: float = 1.0, dy: float = 1.0) -> torch.Tensor:
    """du/dx + dv/dy of (..., H, W, C>=2) fields, as ``vorticity``."""
    return gradient(fields[..., 0], -1) / dx + gradient(fields[..., 1], -2) / dy


def relative_l2(pred: torch.Tensor, ref: torch.Tensor, axes=None) -> torch.Tensor:
    """||pred - ref||_2 / ||ref||_2 over ``axes`` (default: all)."""
    axes = _axes(axes, ref.dim())
    num = torch.sqrt(((pred - ref) ** 2).sum(dim=axes))
    return num / (torch.sqrt((ref**2).sum(dim=axes)) + 1e-12)


def energy_spectrum(fluct: torch.Tensor, domain: tuple[float, float] | None = None,
                    taper: bool = False, batch_dims: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Radial kinetic-energy spectrum of (..., H, W, Cv) velocity
    fluctuations, averaged over the leading axes.

    ``domain`` (Ly, Lx) bins modes by physical radial wavenumber in bins of
    the smaller fundamental, up to the isotropically resolved k_max (None
    = integer mode index); ``taper`` applies a power-compensated 2-D Hann
    window first (the flows are not periodic). Returns (k, E), each
    (nbins,), with sum(E) = 0.5 <|u'|^2> over the modes |k| <= k_max.
    ``batch_dims`` leading axes are kept, not averaged: E is then
    (*those axes, nbins), one spectrum per index (JAX's ``vmap`` of the
    function over them).
    """
    *lead, h, w, c = fluct.shape
    keep = tuple(lead[:batch_dims])
    ly, lx = (1.0, 1.0) if domain is None else (float(domain[0]), float(domain[1]))
    x = fluct.reshape(*keep, -1, h, w, c).to(F32)
    if taper:
        win = np.hanning(h)[:, None] * np.hanning(w)[None, :]
        win = win / np.sqrt((win**2).mean())
        x = x * _const(win, x)[:, :, None]
    fh = torch.fft.fft2(x, dim=(-3, -2))
    ps = (fh.abs() ** 2).sum(dim=-1).mean(dim=-3) / float(h * w) ** 2
    ky = np.fft.fftfreq(h) * h / ly
    kx = np.fft.fftfreq(w) * w / lx
    kr = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    dk = min(1.0 / ly, 1.0 / lx)
    nbins = int(np.floor(min(h / (2 * ly), w / (2 * lx)) / dk)) + 1
    r = np.round(kr / dk).astype(np.int64)
    bins = torch.as_tensor(np.where(r < nbins, r, nbins).ravel(), device=x.device)
    seg = torch.zeros(*keep, nbins + 1, dtype=F32, device=x.device).index_add_(
        -1, bins, ps.reshape(*keep, -1))
    return torch.arange(nbins, dtype=F32, device=x.device) * dk, 0.5 * seg[..., :nbins]


def fluctuation_pdf(samples: torch.Tensor, bins: int = 64, lo: float | None = None,
                    hi: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram density of pooled samples: (bin centers, density), with
    sum(density) * width = 1. Pass a common (lo, hi) to compare two PDFs;
    a zero-width range widens by 1e-6 (constant samples)."""
    x = samples.reshape(-1)
    lo = float(x.min()) if lo is None else lo
    hi = float(x.max()) if hi is None else hi
    if hi <= lo:
        hi = lo + max(1e-6, abs(lo) * 1e-6)
    density, edges, _ = histogram(x, bins, lo, hi)
    return 0.5 * (edges[:-1] + edges[1:]), density


def wasserstein1(a: torch.Tensor, b: torch.Tensor, n_quantiles: int = 256) -> torch.Tensor:
    """W1 between two empirical 1-D distributions (any shapes, flattened)
    on a midpoint quantile grid: mean |F_a^-1(q) - F_b^-1(q)|."""
    q = (torch.arange(n_quantiles, dtype=F32, device=a.device) + 0.5) / n_quantiles
    return (quantile(a, q) - quantile(b, q)).abs().mean()


def ensemble_crps(members: torch.Tensor, ref: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pointwise fair CRPS of an ensemble (member axis ``axis``, N >= 2):
    mean_i |X_i - y| - sum_{i<j} (X_(j) - X_(i)) / (N(N-1)), the second
    term from the sorted members."""
    x = members.movedim(axis, 0)
    n = x.shape[0]
    if n < 2:
        raise ValueError(
            f"ensemble_crps needs >= 2 members (got {n}); the pairwise self-distance "
            "term is undefined for a single sample"
        )
    t1 = (x - ref[None]).abs().mean(dim=0)
    xs = torch.sort(x, dim=0).values
    i = torch.arange(1, n + 1, dtype=xs.dtype, device=xs.device).reshape(n, *([1] * ref.dim()))
    t2 = ((2.0 * i - n - 1.0) * xs).sum(dim=0) / (n * (n - 1))
    return t1 - t2


def gaussian_crps(mean: torch.Tensor, var: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Closed-form CRPS of N(mean, var):
    sigma (z (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi))."""
    std = torch.sqrt(var + 1e-20)
    z = (ref - mean) / std
    cdf = torch.special.ndtr(z)
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    return std * (z * (2.0 * cdf - 1.0) + 2.0 * pdf - 1.0 / math.sqrt(math.pi))


def ensemble_coverage(members: torch.Tensor, ref: torch.Tensor,
                      levels: tuple[float, ...] = (0.5, 0.8, 0.9, 0.95),
                      axis: int = 0) -> torch.Tensor:
    """For each level q, the fraction of points where ``ref`` lies in the
    ensemble's central q-interval (per-point member quantiles, one sort)."""
    x = members.movedim(axis, 0)
    qs = torch.tensor(levels, dtype=F32)
    bounds = quantile(x, torch.cat([(1.0 - qs) / 2.0, 1.0 - (1.0 - qs) / 2.0]), dim=0)
    n = len(levels)
    inside = (ref >= bounds[:n]) & (ref <= bounds[n:])
    return inside.to(F32).mean(dim=tuple(range(1, inside.dim())))


def interval_z(q) -> torch.Tensor:
    """Two-sided Gaussian threshold ndtri((1 + q) / 2) of the central
    q-interval: the one level-to-threshold map of the fit
    (calibrate.fit_interval_scales) and the scoring (gaussian_coverage)."""
    return torch.special.ndtri(0.5 + torch.as_tensor(q, dtype=F32) / 2.0)


def gaussian_coverage(mean: torch.Tensor, var: torch.Tensor, ref: torch.Tensor,
                      levels: tuple[float, ...] = (0.5, 0.8, 0.9, 0.95),
                      scales=None) -> torch.Tensor:
    """Coverage of the central intervals of N(mean, var), each level's
    interval optionally widened by its own factor in ``scales``."""
    z = (ref - mean).abs() / torch.sqrt(var + 1e-20)
    if scales is None:
        scales = torch.ones(len(levels))
    elif len(scales) != len(levels):
        raise ValueError(
            f"{len(scales)} scales for {len(levels)} levels; per-level recalibration "
            "factors must match the requested levels"
        )
    scales = torch.as_tensor(scales, dtype=F32, device=z.device)
    thr = scales * interval_z(torch.tensor(levels, dtype=F32)).to(z.device)
    return torch.stack([(z <= thr[i]).to(F32).mean() for i in range(len(levels))])


def total_variance(mean_t: torch.Tensor, var_t: torch.Tensor) -> torch.Tensor:
    """Pooled (time x ensemble) variance from per-step ensemble stats:
    var over time of the mean plus the time-mean of the variance."""
    return mean_t.var(dim=0, correction=0) + var_t.mean(dim=0)
