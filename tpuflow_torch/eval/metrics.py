"""The evaluator's metric families.

Counterpart of ``tpuflow/eval/metrics.py``, stage by stage (the JAX
module documents each metric's rationale); ``cli/evaluate.py`` sequences
them:

  * long_reference: converged variance references (``eval.ref_steps``);
  * per_trajectory_metrics: field / TKE / vorticity / divergence errors
    and the bicubic baseline's;
  * members_fn_factory: physical-unit member fields of one trajectory
    from a fields-mode rollout;
  * shape_metrics_traj0: CRPS, coverage, spectra, fluctuation PDFs and
    W1, higher moments and Reynolds stress on the first trajectory;
  * fit_calibration_artifacts: every deployable calibration, fit on the
    fit split, written as ``spread_field.npy``, ``spectral_filter.npz``
    and ``quantile_map.npz`` in the JAX package's formats;
  * score_holdout: the holdout split under each dispersion treatment;
  * calibration_metric_rows: the flat rows of ``eval_metrics.json``.

Tensors stay on the device of the rollout's output; scalars leave it with
``float()`` where the JAX package calls ``float()``. The stages return
their figures as payloads (``[(name, kwargs)]`` with NumPy arrays) for
``eval.plots.draw``, and draw nothing themselves.
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Callable

import numpy as np
import torch

from tpuflow_torch.data.synthetic import generate_case
from tpuflow_torch.eval.baseline import lf_upsample, skill
from tpuflow_torch.eval.calibrate import (
    apply_lf_conditioned_qmap,
    apply_quantile_map,
    apply_quantile_map_stratified,
    apply_spectral_filter,
    ensemble_zscores,
    fit_interval_scales_from_z,
    fit_lf_conditioned_qmap,
    fit_quantile_map,
    fit_quantile_map_stratified,
    fit_spectral_filter,
    fit_spread_field_from_z,
    fit_spread_scale_from_z,
    fit_variance_scale_from_moments,
    scale_members,
    scaled_interval_coverage,
)
from tpuflow_torch.eval.rollout import make_ensemble_rollout
from tpuflow_torch.eval.stats import (
    divergence,
    energy_spectrum,
    ensemble_coverage,
    ensemble_crps,
    fluctuation_pdf,
    relative_l2,
    reynolds_stress_uv,
    tke_field,
    total_variance,
    velocity_moments,
    vorticity,
    wasserstein1,
)

COVERAGE_LEVELS = (0.5, 0.8, 0.9, 0.95)
_LEVELS = tuple(f"{q:.2f}" for q in COVERAGE_LEVELS)
_STATS = ("min", "max", "mean")

# The key set and nesting of eval_metrics.json, as the JAX evaluator
# writes it (runs/r5_eval_oracle): a key maps to None (a number, string
# or bool), "list" (one value per test trajectory) or its sub-keys.
METRIC_KEYS: dict = {
    **dict.fromkeys((
        "test_bpd", "test_bpd_last_step", "tke_rel_l2_mean", "field_rel_l2_mean",
        "vorticity_rel_l2_mean", "divergence_rms_pred", "divergence_rms_ref",
        "divergence_rms_ratio", "divergence_rms_normalized", "ensemble_var_mean",
        "baseline_field_rel_l2_mean", "baseline_tke_rel_l2_mean",
        "baseline_vorticity_rel_l2_mean", "field_skill_vs_baseline", "tke_skill_vs_baseline",
        "vorticity_skill_vs_baseline")),
    "field_rel_l2_per_traj": "list",
    "tke_rel_l2_per_traj": "list",
    **dict.fromkeys((
        "n_test_traj", "steps", "ref_steps", "n_samples", "deployed_spread_scale", "backend",
        "pdf_w1_u", "baseline_pdf_w1_u", "pdf_w1_v", "baseline_pdf_w1_v", "crps_mean")),
    "coverage": _LEVELS,
    **dict.fromkeys((
        "spectrum_rel_l2", "baseline_spectrum_rel_l2", "calibration_steps", "skew_mae",
        "kurt_mae", "reynolds_uv_rel_l2", "spread_scale", "calibration_semantics",
        "variance_scale_fit", "calibration_in_sample", "tke_rel_l2_holdout_raw",
        "tke_rel_l2_holdout_calibrated", "baseline_tke_rel_l2_holdout",
        "tke_skill_holdout_raw", "tke_skill_holdout_calibrated",
        "reynolds_uv_rel_l2_holdout_raw", "reynolds_uv_rel_l2_holdout_calibrated",
        "baseline_reynolds_uv_rel_l2_holdout", "reynolds_skill_holdout_calibrated",
        "pdf_w1_u_holdout_raw", "pdf_w1_u_holdout_calibrated", "baseline_pdf_w1_u_holdout",
        "pdf_w1_u_skill_holdout_calibrated", "pdf_w1_v_holdout_raw",
        "pdf_w1_v_holdout_calibrated", "baseline_pdf_w1_v_holdout",
        "pdf_w1_v_skill_holdout_calibrated", "pdf_w1_u_holdout_qmap",
        "pdf_w1_u_skill_holdout_qmap", "pdf_w1_v_holdout_qmap", "pdf_w1_v_skill_holdout_qmap",
        "pdf_w1_u_holdout_qmaplf", "pdf_w1_u_skill_holdout_qmaplf", "pdf_w1_v_holdout_qmaplf",
        "pdf_w1_v_skill_holdout_qmaplf", "pdf_w1_u_holdout_qmapx",
        "pdf_w1_u_skill_holdout_qmapx", "pdf_w1_v_holdout_qmapx",
        "pdf_w1_v_skill_holdout_qmapx", "spectrum_rel_l2_holdout_raw",
        "spectrum_rel_l2_holdout_speccal", "baseline_spectrum_rel_l2_holdout",
        "spectrum_skill_holdout_raw", "spectrum_skill_holdout_speccal",
        "variance_scale_fit_speccal", "tke_rel_l2_holdout_speccal", "tke_skill_holdout_speccal",
        "reynolds_uv_rel_l2_holdout_speccal", "reynolds_skill_holdout_speccal",
        "pdf_w1_u_holdout_speccal", "pdf_w1_u_skill_holdout_speccal",
        "pdf_w1_v_holdout_speccal", "pdf_w1_v_skill_holdout_speccal")),
    "spectral_filter_stats": _STATS,
    **dict.fromkeys((
        "tke_rel_l2_holdout_fieldcal", "tke_skill_holdout_fieldcal",
        "reynolds_uv_rel_l2_holdout_fieldcal", "reynolds_skill_holdout_fieldcal",
        "pdf_w1_u_holdout_fieldcal", "pdf_w1_u_skill_holdout_fieldcal",
        "pdf_w1_v_holdout_fieldcal", "pdf_w1_v_skill_holdout_fieldcal")),
    "spread_field_stats": _STATS,
    "coverage_holdout_raw": _LEVELS,
    "coverage_holdout_recalibrated": _LEVELS,
    "coverage_holdout_fieldcal": _LEVELS,
    **dict.fromkeys(("crps_holdout_raw", "crps_holdout_recalibrated", "crps_holdout_fieldcal")),
    "interval_scales": _LEVELS,
    "coverage_holdout_per_level": _LEVELS,
    "coverage_holdout_single_factor": _LEVELS,
}


def key_structure(metrics: dict) -> dict:
    """The key set and nesting of a metrics dict in METRIC_KEYS' form."""
    return {k: tuple(v) if isinstance(v, dict) else "list" if isinstance(v, list) else None
            for k, v in metrics.items()}


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _fluct(x: torch.Tensor, axes) -> torch.Tensor:
    """Velocity fluctuations: channels u, v minus their mean over ``axes``."""
    return x[..., :2] - x[..., :2].mean(dim=axes, keepdim=True)


def _levels(v: torch.Tensor) -> dict:
    return {k: float(c) for k, c in zip(_LEVELS, v.cpu().tolist())}


def _log_spec_err(e: torch.Tensor, e_ref: torch.Tensor) -> float:
    return float(relative_l2(torch.log(e[1:] + 1e-20), torch.log(e_ref[1:] + 1e-20)))


def long_reference(cfg, ds, T: int):
    """(physical HF reference of ``eval.ref_steps`` steps per test
    trajectory as NumPy, or None; the reference horizon used). Synthetic
    data only: the test split's generator call, extended."""
    ref_steps = cfg.eval.ref_steps
    if cfg.data.synthetic and ref_steps > T:
        _, hf_long = generate_case(
            cfg.data.case, ds.n_traj, ref_steps, cfg.model.hf_shape, cfg.model.lf_shape,
            seed=cfg.data.seed + 10_000, fixture_version=cfg.data.fixture_version,
        )
        return hf_long, ref_steps
    return None, T


def _grid(cfg) -> tuple[float, float]:
    gh, gw = cfg.model.hf_shape
    return cfg.data.domain_x / gw, cfg.data.domain_y / gh


def per_trajectory_metrics(cfg, ds, means, vars_, hf_ref_long, T: int) -> dict:
    """Whole-horizon physics metrics per test trajectory and the bicubic
    baseline's, in physical units, from the rollout's normalized stats
    ``means``/``vars_`` (n_traj, T, H, W, C) on their device. Returns lists
    per family and the figure payloads' arrays (the TKE sums over
    trajectories; trajectory 0's vorticity at T - 1)."""
    dev = means.device
    dx, dy = _grid(cfg)
    s2 = cfg.eval.spread_scale ** 2
    keys = ("tke_errs", "mean_errs", "var_mean", "vort_errs", "div_rms_pred", "div_rms_ref",
            "vort_rms_ref", "base_field_errs", "base_tke_errs", "base_vort_errs")
    out: dict = {k: [] for k in keys}
    tke_pred_sum = tke_ref_sum = vort_fig = None
    rms = lambda f: float(torch.sqrt((f**2).mean()))  # noqa: E731
    for i in range(ds.n_traj):
        mean = ds.denorm_hf(means[i])
        var = ds.denorm_hf_var(vars_[i])
        hf = ds.denorm_hf(_dev(ds.hf[i, :T], dev))
        lf_up = lf_upsample(ds.denorm_lf(_dev(ds.lf[i, :T], dev)), cfg.model.hf_shape)
        # Pooled (time x ensemble) variance against the HF temporal one;
        # the ensemble term deploys eval.spread_scale (1.0 = raw).
        tke_pred = tke_field(total_variance(mean, var * s2))
        hf_ref_i = _dev(hf_ref_long[i], dev) if hf_ref_long is not None else hf
        tke_ref = tke_field(hf_ref_i.var(dim=0, correction=0))
        out["tke_errs"].append(float(relative_l2(tke_pred, tke_ref)))
        out["mean_errs"].append(float(relative_l2(mean, hf)))
        out["var_mean"].append(float(var.mean()))
        out["base_field_errs"].append(float(relative_l2(lf_up, hf)))
        out["base_tke_errs"].append(
            float(relative_l2(tke_field(lf_up.var(dim=0, correction=0)), tke_ref)))
        vort_pred = vorticity(mean, dx=dx, dy=dy)
        vort_ref = vorticity(hf, dx=dx, dy=dy)
        out["vort_errs"].append(float(relative_l2(vort_pred, vort_ref)))
        out["base_vort_errs"].append(
            float(relative_l2(vorticity(lf_up, dx=dx, dy=dy), vort_ref)))
        out["div_rms_pred"].append(rms(divergence(mean, dx=dx, dy=dy)))
        out["div_rms_ref"].append(rms(divergence(hf, dx=dx, dy=dy)))
        out["vort_rms_ref"].append(rms(vort_ref))
        if i == 0:
            vort_fig = (vort_pred[T - 1].cpu().numpy(), vort_ref[T - 1].cpu().numpy())
        tke_pred_sum = tke_pred if tke_pred_sum is None else tke_pred_sum + tke_pred
        tke_ref_sum = tke_ref if tke_ref_sum is None else tke_ref_sum + tke_ref
    out.update(tke_pred_sum=tke_pred_sum.cpu().numpy(), tke_ref_sum=tke_ref_sum.cpu().numpy(),
               vort_fig=vort_fig)
    return out


def members_fn_factory(model, ds, t_cal: int, n_samples: int, temperature,
                       overflow_redraw: bool = False, clock=None) -> Callable:
    """``members_for(traj_i) -> (members (N, T, H, W, C), hf (T, H, W, C))``
    in physical units on the model's device, from a fields-mode rollout of
    ``t_cal`` steps with a generator seeded ``traj_i`` (the JAX package
    keys it ``PRNGKey(traj_i)``). ``clock`` (a ``StageClock``) times the
    rollouts as "calibration rollouts"."""
    rollout = make_ensemble_rollout(model, n_samples, temperature, "fields",
                                    overflow_redraw=overflow_redraw)
    dev = model.device

    def _members_for(traj_i: int):
        with clock("calibration rollouts") if clock else contextlib.nullcontext():
            f = rollout(_dev(ds.lf[traj_i, :t_cal], dev),
                        torch.Generator(dev).manual_seed(traj_i))  # (T, N, H, W, C)
        return (ds.denorm_hf(f.movedim(1, 0).contiguous()),
                ds.denorm_hf(_dev(ds.hf[traj_i, :t_cal], dev)))

    return _members_for


def shape_metrics_traj0(cfg, ds, members, hf0, hf_ref_long, t_cal: int) -> tuple[dict, list]:
    """CRPS, coverage, spectra, fluctuation PDFs and W1, skewness and
    kurtosis, Reynolds stress on the first test trajectory. Returns (the
    calib dict, figure payloads: energy spectrum, reliability, PDFs)."""
    dev = members.device
    crps = ensemble_crps(members, hf0)
    coverage = ensemble_coverage(members, hf0, levels=COVERAGE_LEVELS)
    # Spectra of velocity fluctuations, physical bins, Hann taper; the
    # prediction's averages over time and members.
    pred_fluct = _fluct(members, (0, 1))
    hf0_ref = _dev(hf_ref_long[0], dev) if hf_ref_long is not None else hf0
    ref_fluct = _fluct(hf0_ref, 0)
    spec_domain = (cfg.data.domain_y, cfg.data.domain_x)
    k_bins, e_pred = energy_spectrum(pred_fluct, spec_domain, taper=True)
    _, e_ref = energy_spectrum(ref_fluct, spec_domain, taper=True)
    lf_up0 = lf_upsample(ds.denorm_lf(_dev(ds.lf[0, :t_cal], dev)), cfg.model.hf_shape)
    base_fluct = _fluct(lf_up0, 0)
    _, e_base = energy_spectrum(base_fluct, spec_domain, taper=True)
    # Fluctuation PDFs on a common range, and W1 per velocity channel over
    # the reference's std.
    pdf_w1 = {}
    pdf_centers, pdf_pred, pdf_ref = [], [], []
    for c, name in enumerate(("u", "v")):
        pf, rf = pred_fluct[..., c], ref_fluct[..., c]
        ref_std = float(rf.std(correction=0)) + 1e-12
        pdf_w1[f"pdf_w1_{name}"] = float(wasserstein1(pf, rf)) / ref_std
        pdf_w1[f"baseline_pdf_w1_{name}"] = float(wasserstein1(base_fluct[..., c], rf)) / ref_std
        lo = float(torch.minimum(pf.min(), rf.min()))
        hi = float(torch.maximum(pf.max(), rf.max()))
        centers, dp = fluctuation_pdf(pf, lo=lo, hi=hi)
        _, dr = fluctuation_pdf(rf, lo=lo, hi=hi)
        pdf_centers.append(centers.cpu().numpy())
        pdf_pred.append(dp.cpu().numpy())
        pdf_ref.append(dr.cpu().numpy())
    calib = {
        **pdf_w1,
        "crps_mean": float(crps.mean()),
        "coverage": _levels(coverage),
        "spectrum_rel_l2": _log_spec_err(e_pred, e_ref),
        "baseline_spectrum_rel_l2": _log_spec_err(e_base, e_ref),
        "calibration_steps": t_cal,
    }
    mom_pred = velocity_moments(members[..., :2], axes=(0, 1))
    mom_ref = velocity_moments(hf0[..., :2], axes=(0,))
    calib["skew_mae"] = float((mom_pred["skew"] - mom_ref["skew"]).abs().mean())
    calib["kurt_mae"] = float((mom_pred["kurt"] - mom_ref["kurt"]).abs().mean())
    calib["reynolds_uv_rel_l2"] = float(relative_l2(
        reynolds_stress_uv(members, axes=(0, 1)), reynolds_stress_uv(hf0, axes=(0,))))
    figures = [
        ("energy_spectrum", dict(k=k_bins.cpu().numpy(), e_pred=e_pred.cpu().numpy(),
                                 e_ref=e_ref.cpu().numpy())),
        ("reliability", dict(levels=np.asarray(COVERAGE_LEVELS),
                             empirical=coverage.cpu().numpy())),
        ("fluctuation_pdf", dict(centers=np.stack(pdf_centers), density_pred=np.stack(pdf_pred),
                                 density_ref=np.stack(pdf_ref))),
    ]
    return calib, figures


def fit_calibration_artifacts(cfg, ds, members0, hf0, members_fn, hf_ref_long, fit_idx,
                              out_dir: pathlib.Path) -> dict:
    """Fit every deployable calibration on the fit trajectories ``fit_idx``
    (one trajectory's member fields live at a time) and write
    ``spread_field.npy``, ``spectral_filter.npz`` and ``quantile_map.npz``
    into ``out_dir``; returns the fitted objects."""
    z_pool, r2_parts, v_parts = [], [], []
    qmap_pred, qmap_ref = {0: [], 1: []}, {0: [], 1: []}
    qmap_pred_x, qmap_ref_x = {0: [], 1: []}, {0: [], 1: []}
    lf_stds = {0: [], 1: []}
    spec_domain = (cfg.data.domain_y, cfg.data.domain_x)
    e_m_parts, e_r_parts, spec_k = [], [], None
    for i in fit_idx:
        m_i, hf_i = (members0, hf0) if i == 0 else members_fn(i)
        dev = m_i.device
        z_pool.append(ensemble_zscores(m_i, hf_i))  # (T, H, W, C): the field fit needs it
        # Raw second moments of the variance-statistic fit; equal counts
        # per trajectory, so equal-weight means pool exactly.
        r2_parts.append(float(((hf_i - m_i.mean(dim=0)) ** 2).mean()))
        v_parts.append(float(m_i.var(dim=0, correction=0).mean()))
        fl_m = _fluct(m_i, (0, 1))
        ref_q_i = _dev(hf_ref_long[i], dev) if hf_ref_long is not None else hf_i
        fl_r = _fluct(ref_q_i, 0)
        spec_k, e_m_i = energy_spectrum(fl_m, spec_domain, taper=True)
        _, e_r_i = energy_spectrum(fl_r, spec_domain, taper=True)
        e_m_parts.append(e_m_i)
        e_r_parts.append(e_r_i)
        lf_up_fit = lf_upsample(ds.denorm_lf(_dev(ds.lf[i, :fl_m.shape[1]], dev)),
                                cfg.model.hf_shape)
        lf_fl_fit = _fluct(lf_up_fit, 0)
        for c in (0, 1):
            lf_stds[c].append(float(lf_fl_fit[..., c].std(correction=0)))
            # Stride-7 subsamples (coprime with every grid dimension) of the
            # fluctuation marginals, pooled and per x-column.
            qmap_pred[c].append(fl_m[..., c].reshape(-1)[::7].clone())
            qmap_ref[c].append(fl_r[..., c].reshape(-1)[::7].clone())
            w_ax_m = fl_m[..., c].movedim(-1, 0)
            qmap_pred_x[c].append(w_ax_m.reshape(w_ax_m.shape[0], -1)[:, ::7].clone())
            w_ax_r = fl_r[..., c].movedim(-1, 0)
            qmap_ref_x[c].append(w_ax_r.reshape(w_ax_r.shape[0], -1))
        del m_i, fl_m, fl_r
    z_fields = torch.cat(z_pool, dim=0)
    del z_pool
    z_f = z_fields.reshape(-1)
    scale = fit_spread_scale_from_z(z_f)
    s_field = fit_spread_field_from_z(z_fields)
    del z_fields
    # Deployable: the rollout CLI's eval.spread_field (var * s_field^2).
    np.save(out_dir / "spread_field.npy", s_field.cpu().numpy())
    iscales = fit_interval_scales_from_z(z_f, levels=COVERAGE_LEVELS)
    del z_f
    var_factor = float(fit_variance_scale_from_moments(
        float(np.mean(r2_parts)), float(np.mean(v_parts)), cfg.eval.n_samples))
    qmaps = {c: fit_quantile_map(torch.cat(qmap_pred[c]), torch.cat(qmap_ref[c]))
             for c in (0, 1)}
    qmaps_x = {c: fit_quantile_map_stratified(torch.cat(qmap_pred_x[c], dim=1),
                                              torch.cat(qmap_ref_x[c], dim=1))
               for c in (0, 1)}
    qmaps_lf = {c: fit_lf_conditioned_qmap(qmap_pred[c], qmap_ref[c], lf_stds[c])
                for c in (0, 1)}
    # The deployed spectral chain is filter then variance scale, so the
    # chain's variance factor is refit on the filtered members.
    spec_filter = fit_spectral_filter(torch.stack(e_m_parts).mean(dim=0),
                                      torch.stack(e_r_parts).mean(dim=0), spec_k)
    r2f_parts, vf_parts = [], []
    for i in fit_idx:
        m_i, hf_i = (members0, hf0) if i == 0 else members_fn(i)
        m_f = apply_spectral_filter(m_i, *spec_filter, spec_domain)
        r2f_parts.append(float(((hf_i - m_f.mean(dim=0)) ** 2).mean()))
        vf_parts.append(float(m_f.var(dim=0, correction=0).mean()))
        del m_i, m_f
    var_factor_sf = float(fit_variance_scale_from_moments(
        float(np.mean(r2f_parts)), float(np.mean(vf_parts)), cfg.eval.n_samples))
    npy = lambda t: t.cpu().numpy()  # noqa: E731
    np.savez(out_dir / "spectral_filter.npz", k=npy(spec_filter[0]), s=npy(spec_filter[1]),
             variance_scale=var_factor_sf, domain=np.asarray(spec_domain))
    np.savez(
        out_dir / "quantile_map.npz",
        **{f"{ax}{c}": npy(a) for c, (xq, yq) in qmaps.items() for ax, a in (("x", xq), ("y", yq))},
        **{f"s{ax}{c}": npy(a) for c, (xq, yq) in qmaps_x.items()
           for ax, a in (("x", xq), ("y", yq))},
        **{f"l{ax}{c}": npy(a) for c, (xq, yq, _a) in qmaps_lf.items()
           for ax, a in (("x", xq), ("y", yq))},
        **{f"lalpha{c}": np.asarray(a) for c, (_x, _y, a) in qmaps_lf.items()},
    )
    return {"scale": scale, "s_field": s_field, "iscales": iscales, "var_factor": var_factor,
            "qmaps": qmaps, "qmaps_x": qmaps_x, "qmaps_lf": qmaps_lf,
            "spec_filter": spec_filter, "var_factor_sf": var_factor_sf,
            "spec_domain": spec_domain}


def score_holdout(cfg, ds, members0, hf0, members_fn, hf_ref_long, report_idx, fits: dict,
                  t_cal: int) -> dict:
    """Second-moment physics, W1, spectra, coverage and CRPS on the holdout
    trajectories under every dispersion treatment (raw, variance-
    calibrated, per-location field, spectral chain, quantile maps) and the
    bicubic baseline, averaged over ``report_idx``."""
    scale, s_field, iscales = fits["scale"], fits["s_field"], fits["iscales"]
    var_factor = fits["var_factor"]
    qmaps, qmaps_x = fits["qmaps"], fits["qmaps_x"]
    spec_domain = fits["spec_domain"]
    cov_raw = cov_cal = cov_fld = cov_q = cov_s1 = 0.0
    crps_raw = crps_cal = crps_fld = 0.0
    tags = ("raw", "cal", "fld", "sfc")
    sm = dict.fromkeys(
        [f"{f}_{t}" for f in ("tke", "rey") for t in (*tags, "base")]
        + [f"w1{c}_{t}" for c in "uv" for t in (*tags, "qmap", "qmapx", "qmaplf", "base")]
        + ["spec_raw", "spec_sfc", "spec_base"], 0.0)
    for i in report_idx:
        m_i, hf_i = (members0, hf0) if i == 0 else members_fn(i)
        dev = m_i.device
        m_cal = scale_members(m_i, scale)
        m_fld = scale_members(m_i, s_field)
        # Variance statistics take the unbiased variance-fit factor; the
        # field keeps its structure at that magnitude.
        m_vcal = scale_members(m_i, var_factor)
        m_vfld = scale_members(m_i, s_field * (var_factor / max(float(scale), 1e-12)))
        m_sfc = scale_members(apply_spectral_filter(m_i, *fits["spec_filter"], spec_domain),
                              fits["var_factor_sf"])
        cov_raw += ensemble_coverage(m_i, hf_i, levels=COVERAGE_LEVELS)
        cov_cal += ensemble_coverage(m_cal, hf_i, levels=COVERAGE_LEVELS)
        cov_fld += ensemble_coverage(m_fld, hf_i, levels=COVERAGE_LEVELS)
        crps_raw += float(ensemble_crps(m_i, hf_i).mean())
        crps_cal += float(ensemble_crps(m_cal, hf_i).mean())
        crps_fld += float(ensemble_crps(m_fld, hf_i).mean())
        mu_i, var_i = m_i.mean(dim=0), m_i.var(dim=0, correction=0)
        cov_q += scaled_interval_coverage(mu_i, var_i, hf_i, iscales, levels=COVERAGE_LEVELS)
        # The single factor on the same two-moment construction.
        cov_s1 += scaled_interval_coverage(mu_i, var_i, hf_i,
                                           torch.full((len(COVERAGE_LEVELS),), float(scale)),
                                           levels=COVERAGE_LEVELS)
        lf_up_i = lf_upsample(ds.denorm_lf(_dev(ds.lf[i, :t_cal], dev)), cfg.model.hf_shape)
        hf_ref_i = _dev(hf_ref_long[i], dev) if hf_ref_long is not None else hf_i
        ref_tke_i = tke_field(hf_ref_i.var(dim=0, correction=0))
        rey_ref_i = reynolds_stress_uv(hf_ref_i, axes=(0,))
        treated = {"raw": m_i, "cal": m_vcal, "fld": m_vfld, "sfc": m_sfc}
        for tag, m in treated.items():
            sm[f"tke_{tag}"] += float(relative_l2(tke_field(m.var(dim=(0, 1), correction=0)),
                                                  ref_tke_i))
            sm[f"rey_{tag}"] += float(relative_l2(reynolds_stress_uv(m, axes=(0, 1)), rey_ref_i))
        sm["tke_base"] += float(relative_l2(tke_field(lf_up_i.var(dim=0, correction=0)),
                                            ref_tke_i))
        sm["rey_base"] += float(relative_l2(reynolds_stress_uv(lf_up_i, axes=(0,)), rey_ref_i))
        base_fl_i = _fluct(lf_up_i, 0)
        ref_fl_i = _fluct(hf_ref_i, 0)
        raw_fl = _fluct(m_i, (0, 1))
        _, e_ref_h = energy_spectrum(ref_fl_i, spec_domain, taper=True)
        for tag, fl_h in (("raw", raw_fl), ("sfc", _fluct(m_sfc, (0, 1))), ("base", base_fl_i)):
            _, e_h = energy_spectrum(fl_h, spec_domain, taper=True)
            sm[f"spec_{tag}"] += _log_spec_err(e_h, e_ref_h)
        for c, cname in enumerate(("u", "v")):
            ref_c = ref_fl_i[..., c]
            ref_std_i = float(ref_c.std(correction=0)) + 1e-12
            w1 = lambda a: float(wasserstein1(a, ref_c)) / ref_std_i  # noqa: E731
            for tag, m in treated.items():
                sm[f"w1{cname}_{tag}"] += w1(_fluct(m, (0, 1))[..., c])
            sm[f"w1{cname}_qmap"] += w1(apply_quantile_map(raw_fl[..., c], *qmaps[c]))
            sm[f"w1{cname}_qmapx"] += w1(apply_quantile_map_stratified(
                raw_fl[..., c].movedim(-1, 0), *qmaps_x[c]))
            # LF-conditioned: only the holdout trajectory's own statistics.
            sm[f"w1{cname}_qmaplf"] += w1(apply_lf_conditioned_qmap(
                raw_fl[..., c], float(raw_fl[..., c].std(correction=0)),
                float(base_fl_i[..., c].std(correction=0)), *fits["qmaps_lf"][c]))
            sm[f"w1{cname}_base"] += w1(base_fl_i[..., c])
        del m_i, m_cal, m_fld, m_vcal, m_vfld, m_sfc, raw_fl, treated
    n_rep = len(report_idx)
    return {
        "sm": {k: v / n_rep for k, v in sm.items()},
        "cov_raw": cov_raw / n_rep,
        "cov_cal": cov_cal / n_rep,
        "cov_fld": cov_fld / n_rep,
        "cov_q": cov_q / n_rep,
        "cov_s1": cov_s1 / n_rep,
        "crps_raw": crps_raw / n_rep,
        "crps_cal": crps_cal / n_rep,
        "crps_fld": crps_fld / n_rep,
    }


def calibration_metric_rows(fits: dict, scores: dict, hold_idx) -> dict:
    """The flat eval_metrics.json rows of the calibration families, in the
    JAX evaluator's order and names (its comments say what each holds)."""
    sm = scores["sm"]
    s_field, sf = fits["s_field"], fits["spec_filter"][1]
    rows: dict = dict(
        spread_scale=float(fits["scale"]),
        calibration_semantics="varcal-since-r3 (variance-scale fit; see eval/calibrate.py)",
        variance_scale_fit=fits["var_factor"],
        calibration_in_sample=(not hold_idx),
        tke_rel_l2_holdout_raw=sm["tke_raw"],
        tke_rel_l2_holdout_calibrated=sm["tke_cal"],
        baseline_tke_rel_l2_holdout=sm["tke_base"],
        tke_skill_holdout_raw=skill(sm["tke_raw"], sm["tke_base"]),
        tke_skill_holdout_calibrated=skill(sm["tke_cal"], sm["tke_base"]),
        reynolds_uv_rel_l2_holdout_raw=sm["rey_raw"],
        reynolds_uv_rel_l2_holdout_calibrated=sm["rey_cal"],
        baseline_reynolds_uv_rel_l2_holdout=sm["rey_base"],
        reynolds_skill_holdout_calibrated=skill(sm["rey_cal"], sm["rey_base"]),
    )
    for c in "uv":
        base = sm[f"w1{c}_base"]
        rows.update({
            f"pdf_w1_{c}_holdout_raw": sm[f"w1{c}_raw"],
            f"pdf_w1_{c}_holdout_calibrated": sm[f"w1{c}_cal"],
            f"baseline_pdf_w1_{c}_holdout": base,
            f"pdf_w1_{c}_skill_holdout_calibrated": skill(sm[f"w1{c}_cal"], base),
        })
    for tag in ("qmap", "qmaplf", "qmapx"):
        for c in "uv":
            rows[f"pdf_w1_{c}_holdout_{tag}"] = sm[f"w1{c}_{tag}"]
            rows[f"pdf_w1_{c}_skill_holdout_{tag}"] = skill(sm[f"w1{c}_{tag}"], sm[f"w1{c}_base"])
    rows.update(
        spectrum_rel_l2_holdout_raw=sm["spec_raw"],
        spectrum_rel_l2_holdout_speccal=sm["spec_sfc"],
        baseline_spectrum_rel_l2_holdout=sm["spec_base"],
        spectrum_skill_holdout_raw=skill(sm["spec_raw"], sm["spec_base"]),
        spectrum_skill_holdout_speccal=skill(sm["spec_sfc"], sm["spec_base"]),
        variance_scale_fit_speccal=fits["var_factor_sf"],
    )
    for tag, name in (("sfc", "speccal"), ("fld", "fieldcal")):
        rows.update({
            f"tke_rel_l2_holdout_{name}": sm[f"tke_{tag}"],
            f"tke_skill_holdout_{name}": skill(sm[f"tke_{tag}"], sm["tke_base"]),
            f"reynolds_uv_rel_l2_holdout_{name}": sm[f"rey_{tag}"],
            f"reynolds_skill_holdout_{name}": skill(sm[f"rey_{tag}"], sm["rey_base"]),
        })
        for c in "uv":
            rows[f"pdf_w1_{c}_holdout_{name}"] = sm[f"w1{c}_{tag}"]
            rows[f"pdf_w1_{c}_skill_holdout_{name}"] = skill(sm[f"w1{c}_{tag}"],
                                                             sm[f"w1{c}_base"])
        if tag == "sfc":
            rows["spectral_filter_stats"] = {"min": float(sf.min()), "max": float(sf.max()),
                                             "mean": float(sf.mean())}
    rows.update(
        spread_field_stats={"min": float(s_field.min()), "max": float(s_field.max()),
                            "mean": float(s_field.mean())},
        coverage_holdout_raw=_levels(scores["cov_raw"]),
        coverage_holdout_recalibrated=_levels(scores["cov_cal"]),
        coverage_holdout_fieldcal=_levels(scores["cov_fld"]),
        crps_holdout_raw=scores["crps_raw"],
        crps_holdout_recalibrated=scores["crps_cal"],
        crps_holdout_fieldcal=scores["crps_fld"],
        interval_scales=_levels(fits["iscales"]),
        coverage_holdout_per_level=_levels(scores["cov_q"]),
        coverage_holdout_single_factor=_levels(scores["cov_s1"]),
    )
    return rows
