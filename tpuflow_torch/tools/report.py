"""Consolidated evaluation report: one markdown file per case.

Counterpart of ``tpuflow/tools/report.py``, with the same markdown: it
gathers what one evaluation run wrote (held-out likelihood, field and
physics errors, UQ calibration before and after recalibration, rollout
throughput, the figures) into ``report.md`` beside them.

Usage:
  python -m tpuflow_torch.tools.report <case> [key=value ...]

Reads ``{eval.output_dir}/{case}/eval_metrics.json`` (written by
``python -m tpuflow_torch.cli.evaluate``) and, when present,
``rollout_metrics.json`` and ``temperature_sweep.json``; fails with
guidance if the evaluator has not run. Where matplotlib is installed it
first draws ``training_curves.png`` from the run's ``train_log.csv`` and
``val_log.csv`` (under ``train.checkpoint_dir/<case>``).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

from tpuflow_torch.cli import as_console_script


def _fmt(v, nd=4) -> str:
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _coverage_table(metrics: dict) -> list[str]:
    """Nominal-vs-empirical coverage table across all reported interval
    constructions (raw, single-factor, per-level)."""
    raw = metrics.get("coverage_holdout_raw")
    if not raw:
        return []
    rows = {
        "raw ensemble quantiles": raw,
        "recalibrated ensemble quantiles": metrics.get(
            "coverage_holdout_recalibrated", {}
        ),
        "two-moment, single factor": metrics.get(
            "coverage_holdout_single_factor", {}
        ),
        "two-moment, per-level factors": metrics.get(
            "coverage_holdout_per_level", {}
        ),
    }
    levels = sorted(raw)
    lines = [
        "| interval construction | " + " | ".join(levels) + " |",
        "|---|" + "---|" * len(levels),
    ]
    for name, cov in rows.items():
        if cov:
            lines.append(
                f"| {name} | "
                + " | ".join(_fmt(cov.get(q, float("nan")), 3) for q in levels)
                + " |"
            )
    scope = "IN-SAMPLE (single test trajectory)" if metrics.get(
        "calibration_in_sample"
    ) else "held-out (disjoint fit/report trajectories)"
    lines.append(f"\nCalibration scope: {scope}; fitted spread_scale "
                 f"{_fmt(metrics.get('spread_scale', float('nan')))} — deploy "
                 "via `eval.spread_scale` on the rollout CLI.")
    return lines


def build_report(out_dir: pathlib.Path, case: str) -> str:
    metrics_path = out_dir / "eval_metrics.json"
    if not metrics_path.exists():
        raise FileNotFoundError(
            f"{metrics_path} not found — run "
            f"`python -m tpuflow_torch.cli.evaluate {case}` first"
        )
    m = json.loads(metrics_path.read_text())
    lines = [
        f"# {case} — evaluation report",
        "",
        f"Generated {time.strftime('%Y-%m-%d %H:%M:%S UTC', time.gmtime())} "
        f"from `{metrics_path.name}` (backend: {m.get('backend', '?')}, "
        f"{m.get('n_test_traj', '?')} test trajectories, "
        f"{m.get('steps', '?')} steps, {m.get('n_samples', '?')}-member "
        "ensemble).",
        "",
        "## Held-out likelihood and physics",
        "",
        "Every metric family prints model vs the trivial bicubic LF-"
        "upsampling baseline side by side (skill > 1 = model beats it; "
        "— = no baseline defined for that metric).",
        "",
        "| metric | model | baseline | skill |",
        "|---|---|---|---|",
    ]

    def _skill_row(label, key, base_key, skill_key=None):
        """One table row; skill falls back to baseline/model when no
        precomputed ratio exists (both are error-like: lower better)."""
        if key not in m:
            return None
        model_v = m[key]
        if base_key and base_key in m:
            base_v = m[base_key]
            s = m.get(skill_key) if skill_key else None
            if s is None and isinstance(model_v, float) and model_v > 0:
                s = base_v / model_v
            return (
                f"| {label} | {_fmt(model_v)} | {_fmt(base_v)} | "
                f"{_fmt(s) if s is not None else '—'} |"
            )
        return f"| {label} | {_fmt(model_v)} | — | — |"

    physics = [
        ("test NLL (bits/dim)", "test_bpd", None, None),
        ("field rel-L2 (ensemble mean vs HF)", "field_rel_l2_mean",
         "baseline_field_rel_l2_mean", "field_skill_vs_baseline"),
        ("TKE rel-L2", "tke_rel_l2_mean",
         "baseline_tke_rel_l2_mean", "tke_skill_vs_baseline"),
        ("vorticity rel-L2", "vorticity_rel_l2_mean",
         "baseline_vorticity_rel_l2_mean", "vorticity_skill_vs_baseline"),
        ("divergence RMS ratio (pred/HF)", "divergence_rms_ratio",
         None, None),
        ("divergence RMS / ref vorticity RMS", "divergence_rms_normalized",
         None, None),
        ("energy-spectrum log rel-L2", "spectrum_rel_l2",
         "baseline_spectrum_rel_l2", None),
        ("ensemble CRPS", "crps_mean", None, None),
        ("skewness MAE", "skew_mae", None, None),
        ("kurtosis MAE", "kurt_mae", None, None),
        ("Reynolds <u'v'> rel-L2", "reynolds_uv_rel_l2",
         None, None),
        ("u' PDF Wasserstein-1 / std", "pdf_w1_u",
         "baseline_pdf_w1_u", None),
        ("v' PDF Wasserstein-1 / std", "pdf_w1_v",
         "baseline_pdf_w1_v", None),
    ]
    for row in physics:
        line = _skill_row(*row)
        if line:
            lines.append(line)

    if "tke_rel_l2_mean" in m:
        lines += [
            "",
            "Variance-derived rows above (TKE, Reynolds, PDF-W1) score "
            "the ensemble at its RAW deployed dispersion over the full "
            f"{m.get('steps', '?')}-step horizon (eval.spread_scale "
            f"{_fmt(m.get('deployed_spread_scale', 1.0))}); the raw "
            "tau-reduced ensemble is underdispersed by design, so these "
            "are the model's floor. The holdout table below is the "
            "calibrated, like-for-like comparison on the same "
            "fit/holdout protocol the deployment path uses — judge "
            "second-moment capability there.",
        ]

    # Holdout second-moment section: the variance-derived statistics
    # (BASELINE config #4's point) scored raw vs spread-calibrated on
    # the holdout trajectories, always with the baseline column.
    if "tke_rel_l2_holdout_calibrated" in m:
        lines += [
            "",
            "## Second moments on the holdout split "
            "(raw vs calibrated dispersion)",
            "",
            "Spread scale fit on the disjoint even-indexed test "
            "trajectories; scored on the odd-indexed ones "
            f"(spread_scale {_fmt(m.get('spread_scale', float('nan')))}).",
            "",
            "| metric | raw | calibrated | field-cal | baseline | "
            "skill (cal) | skill (field) |",
            "|---|---|---|---|---|---|---|",
        ]
        for label, stem in (
            ("TKE rel-L2", "tke_rel_l2"),
            ("Reynolds <u'v'> rel-L2", "reynolds_uv_rel_l2"),
            ("u' PDF W1 / std", "pdf_w1_u"),
            ("v' PDF W1 / std", "pdf_w1_v"),
        ):
            sstem = {
                "tke_rel_l2": "tke_skill_holdout",
                "reynolds_uv_rel_l2": "reynolds_skill_holdout",
                "pdf_w1_u": "pdf_w1_u_skill_holdout",
                "pdf_w1_v": "pdf_w1_v_skill_holdout",
            }[stem]
            if f"{stem}_holdout_raw" not in m:
                continue
            fld = m.get(f"{stem}_holdout_fieldcal")
            fskill = m.get(f"{sstem}_fieldcal")
            lines.append(
                f"| {label} | {_fmt(m[f'{stem}_holdout_raw'])} | "
                f"{_fmt(m[f'{stem}_holdout_calibrated'])} | "
                f"{_fmt(fld) if fld is not None else '—'} | "
                f"{_fmt(m[f'baseline_{stem}_holdout'])} | "
                f"{_fmt(m.get(f'{sstem}_calibrated', float('nan')))} | "
                f"{_fmt(fskill) if fskill is not None else '—'} |"
            )
        if "spectrum_skill_holdout_speccal" in m:
            lines += [
                "",
                "Spectral-calibration chain (radial filter fit on the "
                "disjoint split, holdout-scored — `spectral_filter.npz`): "
                f"spectrum rel-L2 {_fmt(m.get('spectrum_rel_l2_holdout_raw'))} raw -> "
                f"{_fmt(m.get('spectrum_rel_l2_holdout_speccal'))} filtered vs "
                f"baseline {_fmt(m.get('baseline_spectrum_rel_l2_holdout'))} "
                f"(skill {_fmt(m.get('spectrum_skill_holdout_speccal'))}).",
            ]
        if "pdf_w1_u_holdout_qmap" in m:
            lines += [
                "",
                "Distribution-shape (quantile-map) calibration of the "
                "fluctuation marginals, fit on the disjoint split "
                "(deploys via `quantile_map.npz`): pooled map u' PDF W1 "
                f"{_fmt(m['pdf_w1_u_holdout_qmap'])} (skill "
                f"{_fmt(m['pdf_w1_u_skill_holdout_qmap'])}), v' "
                f"{_fmt(m['pdf_w1_v_holdout_qmap'])} (skill "
                f"{_fmt(m['pdf_w1_v_skill_holdout_qmap'])})."
                + (
                    " Streamwise-stratified maps: u' "
                    f"{_fmt(m['pdf_w1_u_holdout_qmapx'])} (skill "
                    f"{_fmt(m['pdf_w1_u_skill_holdout_qmapx'])}), v' "
                    f"{_fmt(m['pdf_w1_v_holdout_qmapx'])} (skill "
                    f"{_fmt(m['pdf_w1_v_skill_holdout_qmapx'])})."
                    if "pdf_w1_u_holdout_qmapx" in m
                    else ""
                ),
            ]
    lines += ["", "## UQ calibration", ""]
    cov = _coverage_table(m)
    if cov:
        lines += cov
    else:
        lines.append("(no calibration section — ensemble too small or "
                     "calibration_steps=0)")
    if m.get("crps_holdout_raw") is not None:
        lines += [
            "",
            f"Holdout CRPS: {_fmt(m['crps_holdout_raw'])} raw -> "
            f"{_fmt(m.get('crps_holdout_recalibrated', float('nan')))} "
            "recalibrated.",
        ]

    # Deployment: name the ONE recommended calibration artifact chain
    # per metric family, chosen from the measured holdout numbers
    # (VERDICT r3 item 7 — previously spread across docstrings).
    if "tke_rel_l2_holdout_calibrated" in m:
        lines += ["", "## Deployment (recommended calibration chain)", ""]
        crps_opts = {
            "raw ensemble (no calibration)": m.get("crps_holdout_raw"),
            "scalar spread (`eval.spread_scale`"
            f"={_fmt(m.get('spread_scale', float('nan')))})":
                m.get("crps_holdout_recalibrated"),
            "per-location field (`eval.spread_field=spread_field.npy`)":
                m.get("crps_holdout_fieldcal"),
        }
        crps_opts = {k: v for k, v in crps_opts.items() if v is not None}
        if crps_opts:
            best = min(crps_opts, key=crps_opts.get)
            lines.append(
                f"- **Predictive uncertainty (CRPS/intervals):** {best} "
                f"(holdout CRPS {_fmt(crps_opts[best])}); for interval "
                "construction at nominal levels use the per-level "
                "factors in `interval_scales`."
            )
        tke_opts = {
            "raw ensemble variance": m.get("tke_skill_holdout_raw"),
            "variance-scale calibration "
            f"(variance_scale_fit={_fmt(m.get('variance_scale_fit', float('nan')))})":
                m.get("tke_skill_holdout_calibrated"),
            "per-location field calibration":
                m.get("tke_skill_holdout_fieldcal"),
            "spectral-calibration chain (`spectral_filter.npz`)":
                m.get("tke_skill_holdout_speccal"),
        }
        tke_opts = {k: v for k, v in tke_opts.items() if v is not None}
        if tke_opts:
            best = max(tke_opts, key=tke_opts.get)
            lines.append(
                f"- **Variance statistics (TKE/Reynolds):** {best} "
                f"(holdout TKE skill {_fmt(tke_opts[best])} vs bicubic)."
            )
        for c in ("u", "v"):
            raw_v = m.get(f"pdf_w1_{c}_holdout_raw")
            base_v = m.get(f"baseline_pdf_w1_{c}_holdout")
            shape_opts = {
                "raw": (base_v / max(raw_v, 1e-12))
                if raw_v is not None and base_v is not None else None,
                "variance-scale": m.get(f"pdf_w1_{c}_skill_holdout_calibrated"),
                "pooled quantile map (`quantile_map.npz` x/y)":
                    m.get(f"pdf_w1_{c}_skill_holdout_qmap"),
                "streamwise-stratified map (`quantile_map.npz` sx/sy)":
                    m.get(f"pdf_w1_{c}_skill_holdout_qmapx"),
                "LF-conditioned self-calibrating map "
                "(`quantile_map.npz` lx/ly/lalpha)":
                    m.get(f"pdf_w1_{c}_skill_holdout_qmaplf"),
                "spectral-calibration chain":
                    m.get(f"pdf_w1_{c}_skill_holdout_speccal"),
            }
            shape_opts = {k: v for k, v in shape_opts.items() if v}
            if shape_opts:
                best = max(shape_opts, key=shape_opts.get)
                lines.append(
                    f"- **{c}' fluctuation marginal:** {best} (holdout "
                    f"skill {_fmt(shape_opts[best])})."
                )

    roll_path = out_dir / "rollout_metrics.json"
    if roll_path.exists():
        r = json.loads(roll_path.read_text())
        lines += [
            "",
            "## Rollout throughput",
            "",
            f"- {_fmt(r.get('rollout_steps_per_sec', float('nan')))} steps/s "
            f"({r.get('steps', '?')} steps, {r.get('n_samples', '?')}-member "
            f"ensemble, tau={r.get('temperature', '?')}, backend "
            f"{r.get('backend', '?')})",
        ]

    sweep_path = out_dir / "temperature_sweep.json"
    if sweep_path.exists():
        lines += [
            "",
            "## Temperature study",
            "",
            "See `temperature_sweep.png` / `temperature_sweep.json` "
            "(per-tau field/TKE/CRPS/spread trade-off, paper §4).",
        ]

    figs = sorted(p.name for p in out_dir.glob("*.png"))
    if figs:
        lines += ["", "## Figures", ""]
        lines += [f"![{f}]({f})" for f in figs]
    lines.append("")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> pathlib.Path:
    import importlib.util

    from tpuflow_torch.cli import parse_args

    cfg, _ = parse_args(sys.argv[1:] if argv is None else argv,
                        prog="python -m tpuflow_torch.tools.report")
    out_dir = pathlib.Path(cfg.eval.output_dir) / cfg.name
    if importlib.util.find_spec("matplotlib") is not None:
        # The training curves from the run's logs (nothing without logs,
        # as for an exporter's checkpoint).
        from tpuflow_torch.eval.plots import plot_training_curves

        run_dir = pathlib.Path(cfg.train.checkpoint_dir) / cfg.name
        plot_training_curves(out_dir, run_dir / "train_log.csv", run_dir / "val_log.csv")
    else:
        print("matplotlib is not installed: training_curves.png not drawn")

    report = build_report(out_dir, cfg.name)
    path = out_dir / "report.md"
    path.write_text(report)
    print(f"wrote {path}")
    return path


cli = as_console_script(main)

if __name__ == "__main__":
    main()
