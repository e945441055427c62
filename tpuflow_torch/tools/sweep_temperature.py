"""Sampling-temperature (tau) study: the metrics against the temperature.

Counterpart of ``tpuflow/tools/sweep_temperature.py`` (the paper selects
tau = 0.7 by how it trades the ensemble's diversity against its
accuracy). For each tau of a grid, a stats-mode rollout of every test
trajectory over the evaluation horizon gives the field error, the TKE
error, the Gaussian CRPS and the ensemble spread; a fields-mode rollout
on a short window (``eval.calibration_steps``) adds the columns that
decide a tau:

  * ``finite_frac``: the finite share of the members' values;
  * ``pdf_w1_u`` / ``pdf_w1_v``: the normalized fluctuation-PDF
    Wasserstein-1 against the converged ``eval.ref_steps`` reference;
  * ``tke_rel_l2_calibrated``: the TKE rel-L2 after a spread calibration
    fit on the even trajectories and scored on the odd ones.

Trajectory i's stats rollout draws from ``torch.Generator(device)``
seeded i, its fields rollout from one seeded 100 + i.

``sweep()`` is the compute half and runs on the device; ``main()`` also
writes ``temperature_sweep.json`` and draws ``temperature_sweep.png``
(:func:`plot_sweep`, which needs matplotlib: ``main()`` stops at its
start without it).

Usage:
  python -m tpuflow_torch.tools.sweep_temperature <case> \\
      [temperatures=0.3,0.5,0.7,0.9,1.0] [key=value ...] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

from tpuflow_torch.cli import as_console_script, parse_args, pop_tool_args, require_matplotlib
from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import load_dataset
from tpuflow_torch.data.synthetic import generate_case
from tpuflow_torch.eval.calibrate import fit_spread_scale, fit_variance_scale, scale_members
from tpuflow_torch.eval.loading import load_eval_bundle
from tpuflow_torch.eval.rollout import make_ensemble_rollout
from tpuflow_torch.eval.stats import (
    gaussian_crps,
    relative_l2,
    tke_field,
    total_variance,
    wasserstein1,
)

PROG = "python -m tpuflow_torch.tools.sweep_temperature"


def sweep(cfg: CaseConfig, temperatures, device="cuda") -> list[dict]:
    """Run the study for one case config; returns per-tau metric rows."""
    model, norm, _ = load_eval_bundle(cfg, device=device)
    dev = model.device
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    T = min(cfg.eval.rollout_steps, ds.n_steps)
    n = cfg.eval.n_samples
    rollout = make_ensemble_rollout(model, n, collect="stats")
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)  # noqa: E731
    # The tau-independent reference, hoisted out of the temperature loop.
    lf_in = [on_dev(ds.lf[i, :T]) for i in range(ds.n_traj)]
    hf_ref = [on_dev(ds.denorm_hf(ds.hf[i, :T])) for i in range(ds.n_traj)]
    hf_tke = [tke_field(hf.var(dim=0, correction=0)) for hf in hf_ref]

    # The distribution-shape and stability columns: a short fields-mode
    # rollout against the converged references, with a spread
    # calibration fit on one half of the trajectories, scored on the other.
    t_cal = min(cfg.eval.calibration_steps, T)
    shape_cols = t_cal >= 2 and n >= 2
    if shape_cols:
        fields_rollout = make_ensemble_rollout(model, n, collect="fields")
        if cfg.data.synthetic and cfg.eval.ref_steps > t_cal:
            _, hf_long = generate_case(
                cfg.data.case, ds.n_traj, cfg.eval.ref_steps, cfg.model.hf_shape,
                cfg.model.lf_shape, seed=cfg.data.seed + 10_000,
                fixture_version=cfg.data.fixture_version)
            refs = [on_dev(hf_long[i]) for i in range(ds.n_traj)]
        else:
            refs = [hf[:t_cal] for hf in hf_ref]
        fit_idx = list(range(0, ds.n_traj, 2))
        hold_idx = list(range(1, ds.n_traj, 2)) or fit_idx
        # One trajectory: the holdout is the fit set, and every row says so.
        calib_in_sample = hold_idx == fit_idx

    rows = []
    for tau in temperatures:
        tke_errs, field_errs, crps_vals, spreads = [], [], [], []
        for i in range(ds.n_traj):
            out = rollout(lf_in[i], gen(i), float(tau))
            mean, var = ds.denorm_hf(out["mean"]), ds.denorm_hf_var(out["var"])
            hf = hf_ref[i]
            tke_errs.append(float(relative_l2(tke_field(total_variance(mean, var)), hf_tke[i])))
            field_errs.append(float(relative_l2(mean, hf)))
            crps_vals.append(float(gaussian_crps(mean, var, hf).mean()))
            spreads.append(float(torch.sqrt(var).mean()))
        row = {
            "temperature": float(tau),
            "field_rel_l2": float(np.mean(field_errs)),
            "tke_rel_l2": float(np.mean(tke_errs)),
            "gaussian_crps": float(np.mean(crps_vals)),
            "ensemble_std": float(np.mean(spreads)),
        }
        if shape_cols:
            members, finite = {}, []
            for i in range(ds.n_traj):
                f = fields_rollout(lf_in[i][:t_cal], gen(100 + i), float(tau))  # (t, N, H, W, C)
                finite.append(float(torch.isfinite(f).double().mean()))
                members[i] = ds.denorm_hf(f).movedim(1, 0)  # (N, t, H, W, C)
            row["finite_frac"] = float(np.mean(finite))
            if row["finite_frac"] == 1.0:
                row["spread_scale_fit"] = float(np.mean(
                    [float(fit_spread_scale(members[i], refs[i][:t_cal])) for i in fit_idx]))
                v_scale = float(np.mean(
                    [float(fit_variance_scale(members[i], refs[i][:t_cal])) for i in fit_idx]))
                row["variance_scale_fit"] = v_scale
                tke_cal, w1u, w1v = [], [], []
                for i in hold_idx:
                    m_cal = scale_members(members[i], v_scale)
                    ref_i = refs[i]
                    tke_cal.append(float(relative_l2(
                        tke_field(m_cal.var(dim=(0, 1), correction=0)),
                        tke_field(ref_i.var(dim=0, correction=0)))))
                    fl = m_cal[..., :2] - m_cal[..., :2].mean(dim=(0, 1), keepdim=True)
                    rfl = ref_i[..., :2] - ref_i[..., :2].mean(dim=0, keepdim=True)
                    for c, acc in ((0, w1u), (1, w1v)):
                        acc.append(float(wasserstein1(fl[..., c], rfl[..., c]))
                                   / (float(rfl[..., c].std(correction=0)) + 1e-12))
                row["tke_rel_l2_calibrated"] = float(np.mean(tke_cal))
                row["pdf_w1_u"] = float(np.mean(w1u))
                row["pdf_w1_v"] = float(np.mean(w1v))
                row["calibration_in_sample"] = calib_in_sample
        rows.append(row)
    return rows


def plot_sweep(out_dir, rows) -> pathlib.Path:
    """Field rel-L2, TKE rel-L2 and CRPS against tau, as
    ``temperature_sweep.png`` in ``out_dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    taus = [r["temperature"] for r in rows]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    for ax, key in zip(axes, ("field_rel_l2", "tke_rel_l2", "gaussian_crps")):
        ax.plot(taus, [r[key] for r in rows], "o-")
        ax.set_xlabel("temperature tau")
        ax.set_ylabel(key)
        ax.grid(alpha=0.3)
    path = out_dir / "temperature_sweep.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def main(argv: list[str] | None = None) -> list[dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = pop_tool_args(argv, {"temperatures": "0.3,0.5,0.7,0.9,1.0"})
    cfg, device = parse_args(argv, prog=PROG)
    require_matplotlib(PROG)
    rows = sweep(cfg, [float(x) for x in kv["temperatures"].split(",")], device)
    out_dir = pathlib.Path(cfg.eval.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "temperature_sweep.json").write_text(json.dumps(rows, indent=2))
    plot_sweep(out_dir, rows)
    print(json.dumps(rows))
    return rows


cli = as_console_script(main)

if __name__ == "__main__":
    main()
