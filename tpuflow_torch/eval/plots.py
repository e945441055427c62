"""Figures of the evaluator and the rollout CLI.

Counterpart of ``tpuflow/eval/plots.py``, with the same figures and file
names: LF / HF / predicted mean / variance / error panels, TKE,
vorticity, member samples, profiles and probe time series with +-2 sigma
bands, energy spectra, fluctuation PDFs, reliability diagrams, the
held-out NLL curve and the training curves. Matplotlib with the Agg
backend, on NumPy arrays; every function writes a PNG and returns its
path.

The metric stages (``eval/metrics.py``) and the CLIs' compute halves
return their figures as payloads, ``[(name, kwargs), ...]`` with NumPy
arrays; :func:`draw` renders them with ``plot_<name>``. Only the CLIs
import this module, after checking that matplotlib is installed.
"""

from __future__ import annotations

import pathlib

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

_CHANNELS = ("u", "v", "p")


def _finite_max(*fields) -> float:
    """Color-scale bound that survives NaN/Inf fields: a diverged
    rollout is exactly when these figures must still render (nan vmax
    makes imshow draw blank panels with no warning)."""
    vals = [float(np.nanmax(np.abs(np.where(np.isfinite(f), f, 0.0))))
            for f in fields]
    m = max(vals) if vals else 0.0
    return m if np.isfinite(m) and m > 0 else 1.0



def _panel(ax, field, title, cmap="RdBu_r", vlim=None):
    if vlim is None:
        vmax = _finite_max(field)
        vlim = (-vmax, vmax)
    im = ax.imshow(field, cmap=cmap, vmin=vlim[0], vmax=vlim[1], origin="lower")
    ax.set_title(title, fontsize=9)
    ax.set_xticks([])
    ax.set_yticks([])
    plt.colorbar(im, ax=ax, fraction=0.025)


def plot_prediction_panels(
    out_dir: str | pathlib.Path,
    lf: np.ndarray,        # (h, w, C) LF input at time t
    hf: np.ndarray,        # (H, W, C) HF target at time t
    mean: np.ndarray,      # (H, W, C) ensemble mean
    var: np.ndarray,       # (H, W, C) ensemble variance
    t: int,
    channel: int = 0,
) -> pathlib.Path:
    """LF / HF / mean / variance / error panels for one channel."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = _CHANNELS[channel]
    fig, axes = plt.subplots(1, 5, figsize=(18, 3.2))
    vmax = _finite_max(hf[..., channel])
    _panel(axes[0], lf[..., channel], f"LF input {name}", vlim=(-vmax, vmax))
    _panel(axes[1], hf[..., channel], f"HF target {name}", vlim=(-vmax, vmax))
    _panel(axes[2], mean[..., channel], f"pred mean {name}", vlim=(-vmax, vmax))
    _panel(axes[3], var[..., channel], f"pred var {name}", cmap="viridis",
           vlim=(0, _finite_max(var[..., channel])))
    _panel(axes[4], mean[..., channel] - hf[..., channel], f"error {name}")
    fig.suptitle(f"t={t}", fontsize=10)
    path = out_dir / f"pred_t{t:04d}_{name}.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_tke(
    out_dir: str | pathlib.Path,
    tke_pred: np.ndarray,  # (H, W)
    tke_ref: np.ndarray,   # (H, W)
) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    vmax = _finite_max(tke_ref, tke_pred)
    _panel(axes[0], tke_ref, "TKE (HF reference)", cmap="viridis", vlim=(0, vmax))
    _panel(axes[1], tke_pred, "TKE (predicted)", cmap="viridis", vlim=(0, vmax))
    _panel(axes[2], tke_pred - tke_ref, "TKE error")
    path = out_dir / "tke.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_vorticity(
    out_dir: str | pathlib.Path,
    vort_pred: np.ndarray,  # (H, W)
    vort_ref: np.ndarray,   # (H, W)
    t: int,
) -> pathlib.Path:
    """Instantaneous vorticity contours, predicted mean vs HF — the
    reference's cylinder-array comparison figure (arXiv:2006.04731 §4)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    vmax = _finite_max(vort_ref)
    _panel(axes[0], vort_ref, "vorticity (HF reference)", vlim=(-vmax, vmax))
    _panel(axes[1], vort_pred, "vorticity (pred mean)", vlim=(-vmax, vmax))
    _panel(axes[2], vort_pred - vort_ref, "vorticity error")
    fig.suptitle(f"t={t}", fontsize=10)
    path = out_dir / f"vorticity_t{t:04d}.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_samples_grid(
    out_dir: str | pathlib.Path,
    samples: np.ndarray,   # (N, H, W, C) ensemble member fields at one t
    hf: np.ndarray,        # (H, W, C) HF target at the same t
    t: int,
    channel: int = 0,
    max_samples: int = 7,
) -> pathlib.Path:
    """HF target + individual ensemble member samples (the reference's
    sample panels — visualizes the generative spread)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = _CHANNELS[channel]
    n = min(max_samples, samples.shape[0])
    fig, axes = plt.subplots(1, n + 1, figsize=(3.2 * (n + 1), 3.0))
    vmax = _finite_max(hf[..., channel])
    _panel(axes[0], hf[..., channel], f"HF {name}", vlim=(-vmax, vmax))
    for i in range(n):
        _panel(
            axes[i + 1], samples[i, ..., channel], f"sample {i}",
            vlim=(-vmax, vmax),
        )
    path = out_dir / f"samples_t{t:04d}_{name}.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_profiles(
    out_dir: str | pathlib.Path,
    mean: np.ndarray,      # (H, W, C) predicted ensemble mean
    std: np.ndarray,       # (H, W, C) predicted ensemble std
    hf: np.ndarray,        # (H, W, C) HF reference
    x_fracs=(0.25, 0.5, 0.75),
    channel: int = 0,
) -> pathlib.Path:
    """Vertical velocity profiles at x-stations with ±2σ uncertainty
    bands vs the HF reference (the reference paper's profile figures)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = _CHANNELS[channel]
    h, w = mean.shape[:2]
    y = np.arange(h)
    fig, axes = plt.subplots(1, len(x_fracs), figsize=(4 * len(x_fracs), 3.4),
                             sharey=True)
    for ax, xf in zip(np.atleast_1d(axes), x_fracs):
        xi = int(xf * (w - 1))
        m = mean[:, xi, channel]
        s = std[:, xi, channel]
        ax.fill_betweenx(y, m - 2 * s, m + 2 * s, alpha=0.3, label="±2σ")
        ax.plot(m, y, label="pred mean")
        ax.plot(hf[:, xi, channel], y, "--", label="HF")
        ax.set_title(f"{name}(y) at x/L={xf:.2f}", fontsize=9)
        ax.grid(alpha=0.3)
    np.atleast_1d(axes)[0].set_ylabel("y index")
    np.atleast_1d(axes)[-1].legend(fontsize=8)
    path = out_dir / f"profiles_{name}.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_probe_timeseries(
    out_dir: str | pathlib.Path,
    mean: np.ndarray,      # (T, H, W, C) predicted ensemble mean
    std: np.ndarray,       # (T, H, W, C) predicted ensemble std
    hf: np.ndarray,        # (T, H, W, C) HF reference
    probes=((0.5, 0.25), (0.5, 0.5), (0.5, 0.75)),  # (y_frac, x_frac)
    channel: int = 0,
) -> pathlib.Path:
    """Velocity/pressure time series at probe points with ±2σ bands vs
    the HF reference (the reference paper's probe-signal figures —
    tracks whether the autoregressive rollout stays locked to the HF
    transient and whether the band covers it)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = _CHANNELS[channel]
    t_ax = np.arange(mean.shape[0])
    h, w = mean.shape[1:3]
    fig, axes = plt.subplots(
        len(probes), 1, figsize=(7, 2.2 * len(probes)), sharex=True
    )
    for ax, (yf, xf) in zip(np.atleast_1d(axes), probes):
        yi, xi = int(yf * (h - 1)), int(xf * (w - 1))
        m = mean[:, yi, xi, channel]
        s = std[:, yi, xi, channel]
        ax.fill_between(t_ax, m - 2 * s, m + 2 * s, alpha=0.3, label="±2σ")
        ax.plot(t_ax, m, label="pred mean")
        ax.plot(t_ax, hf[:, yi, xi, channel], "--", label="HF")
        ax.set_title(f"{name}(t) at y/H={yf:.2f}, x/L={xf:.2f}", fontsize=9)
        ax.grid(alpha=0.3)
    np.atleast_1d(axes)[-1].set_xlabel("rollout step")
    np.atleast_1d(axes)[0].legend(fontsize=8, ncol=3)
    path = out_dir / f"probes_{name}.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_energy_spectrum(
    out_dir: str | pathlib.Path,
    k: np.ndarray,
    e_pred: np.ndarray,
    e_ref: np.ndarray,
) -> pathlib.Path:
    """Radial kinetic-energy spectrum, predicted ensemble vs HF
    reference (log-log) — see ``stats.energy_spectrum``."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 3.6))
    # k=0 is the (removed) mean mode; start at 1 for log axes.
    ax.loglog(k[1:], np.maximum(e_ref[1:], 1e-20), "--", label="HF reference")
    ax.loglog(k[1:], np.maximum(e_pred[1:], 1e-20), label="predicted")
    ax.set_xlabel("wavenumber k")
    ax.set_ylabel("E(k)")
    ax.grid(alpha=0.3, which="both")
    ax.legend(fontsize=8)
    path = out_dir / "energy_spectrum.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_fluctuation_pdf(
    out_dir: str | pathlib.Path,
    centers: np.ndarray,      # (C, bins) shared bin centers per channel
    density_pred: np.ndarray,  # (C, bins) predicted density per channel
    density_ref: np.ndarray,   # (C, bins) reference density per channel
    channels: tuple[str, ...] = ("u'", "v'"),
) -> pathlib.Path:
    """Velocity-fluctuation PDFs, predicted ensemble vs HF reference
    (the reference's PDF comparison figure, arXiv:2006.04731 §4).
    Log-y density so the non-Gaussian tails — where a generative model
    earns its keep over a Gaussian closure — are visible."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = len(channels)
    fig, axes = plt.subplots(1, n, figsize=(4.2 * n, 3.4))
    axes = np.atleast_1d(axes)
    for c, (ax, name) in enumerate(zip(axes, channels)):
        ax.semilogy(
            centers[c], np.maximum(density_ref[c], 1e-12), "--",
            label="HF reference",
        )
        ax.semilogy(
            centers[c], np.maximum(density_pred[c], 1e-12), label="predicted"
        )
        ax.set_xlabel(name)
        ax.set_ylabel("PDF")
        ax.grid(alpha=0.3, which="both")
        ax.legend(fontsize=8)
    path = out_dir / "fluctuation_pdf.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_reliability(
    out_dir: str | pathlib.Path,
    levels: np.ndarray,
    empirical: np.ndarray,
    label: str = "ensemble",
    recalibrated: np.ndarray | None = None,
    per_level: np.ndarray | None = None,
    suffix: str = "",
) -> pathlib.Path:
    """Reliability diagram: empirical coverage of central predictive
    intervals vs nominal level (diagonal = perfectly calibrated UQ).
    Optionally overlays the post-hoc recalibrated curve
    (eval/calibrate.py spread scaling)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(4, 3.8))
    ax.plot([0, 1], [0, 1], "k--", alpha=0.5, label="perfect")
    ax.plot(levels, empirical, "o-", label=label)
    if recalibrated is not None:
        ax.plot(levels, recalibrated, "s-", label="recalibrated")
    if per_level is not None:
        ax.plot(levels, per_level, "^-", label="per-level recal.")
    ax.set_xlabel("nominal coverage")
    ax.set_ylabel("empirical coverage")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    path = out_dir / f"reliability{suffix}.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_nll_curve(
    out_dir: str | pathlib.Path, bpd_per_step: np.ndarray
) -> pathlib.Path:
    """Held-out bits/dim vs physical time step."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 3.2))
    ax.plot(np.asarray(bpd_per_step))
    ax.set_xlabel("timestep")
    ax.set_ylabel("bits/dim")
    ax.grid(alpha=0.3)
    path = out_dir / "nll_curve.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_training_curves(
    out_dir: str | pathlib.Path,
    train_log: str | pathlib.Path,
    val_log: str | pathlib.Path | None = None,
) -> pathlib.Path | None:
    """Training-NLL curve (epoch-averaged train bits/dim from
    ``train_log.csv``) with the held-out curve from ``val_log.csv``
    overlaid when present (``train.eval_every``). Returns None when the
    train log is missing/empty — report generation must not fail on a
    run that never logged."""
    import csv

    train_log = pathlib.Path(train_log)
    if not train_log.exists():
        return None
    per_epoch: dict[float, list[float]] = {}
    with open(train_log) as f:
        for row in csv.DictReader(f):
            try:
                e, b = float(row["epoch"]), float(row["bpd"])
            except (KeyError, TypeError, ValueError):
                continue
            if np.isfinite(b):
                per_epoch.setdefault(e, []).append(b)
    if not per_epoch:
        return None
    epochs = sorted(per_epoch)
    train_bpd = [float(np.mean(per_epoch[e])) for e in epochs]

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 3.2))
    ax.plot(epochs, train_bpd, label="train")
    if val_log is not None and pathlib.Path(val_log).exists():
        ve, vb = [], []
        with open(val_log) as f:
            for row in csv.DictReader(f):
                try:
                    e, b = float(row["epoch"]), float(row["val_bpd"])
                except (KeyError, TypeError, ValueError):
                    continue
                if np.isfinite(b):
                    ve.append(e)
                    vb.append(b)
        if ve:
            ax.plot(ve, vb, label="held-out", linestyle="--")
    ax.set_xlabel("epoch")
    ax.set_ylabel("bits/dim")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    path = out_dir / "training_curves.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def draw(out_dir: str | pathlib.Path, figures) -> list[pathlib.Path]:
    """Render figure payloads ``[(name, kwargs), ...]`` with
    ``plot_<name>(out_dir, **kwargs)``; returns the paths written."""
    return [globals()[f"plot_{name}"](out_dir, **kw) for name, kw in figures]
