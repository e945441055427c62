"""Held-out evaluation: test NLL, UQ physics statistics against the HF
reference, calibration fits, figures.

Usage: python -m tpuflow_torch.cli.evaluate <case> [key=value ...] [--device cuda|cpu]

Counterpart of ``tpuflow/cli/evaluate.py``. It loads the case's
checkpoint (``eval/loading.py``) and the test split with the
checkpoint's normalization, then:

  * the held-out bits/dim over ``eval.rollout_steps`` (capped at the
    stored steps), teacher-forced (``make_nll_eval``);
  * a stats-mode ensemble rollout of every test trajectory, in batches of
    ``eval.traj_batch`` trajectories x ``eval.n_samples`` members (the
    ragged last batch padded by repeating its last trajectory; the
    padding's results are dropped), trajectory i drawing from a generator
    seeded i;
  * the converged references (``eval.ref_steps``) and the per-trajectory
    metrics against them and against the bicubic baseline;
  * on ``eval.calibration_steps`` steps, fields-mode rollouts: shape
    metrics on trajectory 0, every calibration fit on the even-indexed
    trajectories and scored on the odd-indexed ones (in sample when there
    is one trajectory).

It writes into ``eval.output_dir/<case>``: ``eval_metrics.json`` (the
JAX evaluator's key set and nesting, ``backend`` the torch device type),
``spread_field.npy``, ``spectral_filter.npz``, ``quantile_map.npz`` and
the figures (``nll_curve``, ``energy_spectrum``, ``reliability``,
``fluctuation_pdf``, ``reliability_holdout``, ``vorticity_tNNNN``,
``tke``). ``evaluate()`` is the compute half, without figures; ``main()``
needs matplotlib and stops at its start without it. ``eval.trace_dir``
records a ``torch.profiler`` trace of the batched rollout.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from tpuflow_torch.cli import as_console_script, parse_args, require_matplotlib
from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import load_dataset
from tpuflow_torch.device import resolve_device
from tpuflow_torch.eval.baseline import skill
from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
from tpuflow_torch.eval.metrics import (
    COVERAGE_LEVELS,
    calibration_metric_rows,
    fit_calibration_artifacts,
    long_reference,
    members_fn_factory,
    per_trajectory_metrics,
    score_holdout,
    shape_metrics_traj0,
)
from tpuflow_torch.eval.rollout import make_batched_ensemble_rollout, make_nll_eval
from tpuflow_torch.utils.profiling import StageClock, trace_context

PROG = "python -m tpuflow_torch.cli.evaluate"


def evaluate(cfg: CaseConfig, device: str | torch.device = "cuda",
             seconds: dict | None = None) -> tuple[dict, list]:
    """Evaluate the case's checkpoint; writes ``eval_metrics.json`` and the
    calibration artefacts, and returns (metrics, figure payloads for
    ``eval.plots.draw``). ``seconds`` receives the seconds of each stage:
    load, nll, batched rollout, reference, calibration rollouts, metrics."""
    dev = resolve_device(device)
    clock = StageClock(dev, seconds)
    with clock("load"):
        model, norm, meta = load_eval_bundle(cfg, device=dev)
        temperature = resolve_temperature(cfg, meta, device=dev)
        ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    if ds.n_traj == 0:
        raise ValueError("test split is empty: nothing to evaluate")
    T = min(cfg.eval.rollout_steps, ds.n_steps)
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    with clock("nll"):
        bpds = make_nll_eval(model)(on_dev(ds.lf[:, :T]), on_dev(ds.hf[:, :T]))
        bpd_per_step = bpds.cpu().numpy().mean(axis=1)

    bsz = min(max(1, cfg.eval.traj_batch), ds.n_traj)
    rollout = make_batched_ensemble_rollout(model, cfg.eval.n_samples, temperature, "stats",
                                            overflow_redraw=cfg.eval.overflow_redraw)
    means_l, vars_l = [], []
    with clock("batched rollout"), trace_context(cfg.eval.trace_dir):
        for start in range(0, ds.n_traj, bsz):
            idx = list(range(start, min(start + bsz, ds.n_traj)))
            idx_p = idx + [idx[-1]] * (bsz - len(idx))
            out = rollout(on_dev(ds.lf[idx_p, :T]),
                          [torch.Generator(dev).manual_seed(i) for i in idx_p])
            means_l.append(out["mean"][: len(idx)])
            vars_l.append(out["var"][: len(idx)])
    means, vars_ = torch.cat(means_l), torch.cat(vars_l)
    del means_l, vars_l, out

    with clock("reference"):
        hf_ref_long, ref_steps = long_reference(cfg, ds, T)

    out_dir = pathlib.Path(cfg.eval.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    with clock("metrics"):
        pt = per_trajectory_metrics(cfg, ds, means, vars_, hf_ref_long, T)
        figures: list = [("nll_curve", dict(bpd_per_step=bpd_per_step))]
        calib: dict = {}
        t_cal = min(cfg.eval.calibration_steps, T)
        # Ensemble CRPS and coverage are undefined for a single member.
        if t_cal > 0 and cfg.eval.n_samples >= 2:
            members_fn = members_fn_factory(model, ds, t_cal, cfg.eval.n_samples, temperature,
                                            overflow_redraw=cfg.eval.overflow_redraw,
                                            clock=clock)
            members, hf0 = members_fn(0)
            calib, figs = shape_metrics_traj0(cfg, ds, members, hf0, hf_ref_long, t_cal)
            figures += figs
            # Fit on the even-indexed trajectories, score on the odd ones.
            fit_idx = list(range(0, ds.n_traj, 2))
            hold_idx = list(range(1, ds.n_traj, 2))
            fits = fit_calibration_artifacts(cfg, ds, members, hf0, members_fn, hf_ref_long,
                                             fit_idx, out_dir)
            scores = score_holdout(cfg, ds, members, hf0, members_fn, hf_ref_long,
                                   hold_idx or [0], fits, t_cal)
            calib.update(calibration_metric_rows(fits, scores, hold_idx))
            figures.append(("reliability", dict(
                levels=np.asarray(COVERAGE_LEVELS), empirical=scores["cov_raw"].cpu().numpy(),
                recalibrated=scores["cov_cal"].cpu().numpy(),
                per_level=scores["cov_q"].cpu().numpy(), suffix="_holdout")))
            del members, hf0
        if pt["vort_fig"] is not None:
            figures.append(("vorticity", dict(vort_pred=pt["vort_fig"][0],
                                              vort_ref=pt["vort_fig"][1], t=T - 1)))
        figures.append(("tke", dict(tke_pred=pt["tke_pred_sum"] / ds.n_traj,
                                    tke_ref=pt["tke_ref_sum"] / ds.n_traj)))

    mean_of = lambda k: float(np.mean(pt[k]))  # noqa: E731
    metrics = {
        "test_bpd": float(np.mean(bpd_per_step)),
        "test_bpd_last_step": float(bpd_per_step[-1]),
        "tke_rel_l2_mean": mean_of("tke_errs"),
        "field_rel_l2_mean": mean_of("mean_errs"),
        "vorticity_rel_l2_mean": mean_of("vort_errs"),
        "divergence_rms_pred": mean_of("div_rms_pred"),
        "divergence_rms_ref": mean_of("div_rms_ref"),
        "divergence_rms_ratio": float(np.mean(pt["div_rms_pred"])
                                      / (np.mean(pt["div_rms_ref"]) + 1e-12)),
        # Prediction's divergence RMS over the reference's vorticity RMS.
        "divergence_rms_normalized": float(np.mean(pt["div_rms_pred"])
                                           / (np.mean(pt["vort_rms_ref"]) + 1e-12)),
        "ensemble_var_mean": mean_of("var_mean"),
        "baseline_field_rel_l2_mean": mean_of("base_field_errs"),
        "baseline_tke_rel_l2_mean": mean_of("base_tke_errs"),
        "baseline_vorticity_rel_l2_mean": mean_of("base_vort_errs"),
        "field_skill_vs_baseline": skill(np.mean(pt["mean_errs"]), np.mean(pt["base_field_errs"])),
        "tke_skill_vs_baseline": skill(np.mean(pt["tke_errs"]), np.mean(pt["base_tke_errs"])),
        "vorticity_skill_vs_baseline": skill(np.mean(pt["vort_errs"]),
                                             np.mean(pt["base_vort_errs"])),
        "field_rel_l2_per_traj": [float(e) for e in pt["mean_errs"]],
        "tke_rel_l2_per_traj": [float(e) for e in pt["tke_errs"]],
        "n_test_traj": ds.n_traj,
        "steps": T,
        "ref_steps": ref_steps,
        "n_samples": cfg.eval.n_samples,
        # The dispersion the whole-horizon variance rows deployed; the one
        # this evaluation fits is "spread_scale".
        "deployed_spread_scale": float(cfg.eval.spread_scale),
        "backend": dev.type,
        **calib,
    }
    (out_dir / "eval_metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics, figures


def main(argv: list[str] | None = None, seconds: dict | None = None) -> dict:
    """The CLI: evaluate, then draw the figures; returns the metrics.
    ``seconds`` receives the stage seconds, "figures" included."""
    cfg, device = parse_args(argv, prog=PROG)
    require_matplotlib(PROG)
    from tpuflow_torch.eval.plots import draw

    seconds = {} if seconds is None else seconds
    metrics, figures = evaluate(cfg, device, seconds)
    t0 = time.perf_counter()
    draw(pathlib.Path(cfg.eval.output_dir) / cfg.name, figures)
    seconds["figures"] = time.perf_counter() - t0
    print(json.dumps(metrics))
    print("stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return metrics


cli = as_console_script(main)

if __name__ == "__main__":
    main()
