"""Band-wise member-fluctuation spectrum probe over a per-scale tau grid.

Counterpart of ``tpuflow/tools/probe_spectrum.py``. It sweeps per-scale
temperatures (the Glow's reverse takes a tau per scale; scale 0 is the
finest split) through one fields-mode rollout of the case's checkpoint,
and reports for each setting:

  * ``spectrum_rel_l2``: the evaluator's metric (Hann taper, physical
    wavenumber bins, log rel-L2 against the converged reference);
  * ``band_log10_ratio``: log10(E_model / E_hf) over four upper
    wavenumber bands;
  * ``field_rel_l2``: the ensemble mean's rel-L2 (so damping that costs
    accuracy shows);
  * ``tke_rel_l2_raw``: the pooled TKE's rel-L2 against the converged
    temporal reference;
  * ``finite_frac``: the finite share of the members' values.

Every setting draws from ``torch.Generator(device).manual_seed(0)``.

Usage: python -m tpuflow_torch.tools.probe_spectrum <case> [key=value ...] [--device cuda|cpu]
Writes the rows to <eval.output_dir>/<case>/spectrum_probe.json.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

from tpuflow_torch.cli import as_console_script, parse_args
from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import load_dataset
from tpuflow_torch.data.synthetic import generate_case
from tpuflow_torch.eval.loading import load_eval_bundle
from tpuflow_torch.eval.rollout import make_ensemble_rollout
from tpuflow_torch.eval.stats import energy_spectrum, relative_l2, tke_field

PROG = "python -m tpuflow_torch.tools.probe_spectrum"


def tau_grid(base: float, n_scales: int) -> list[tuple[str, list[float]]]:
    """Per-scale tau settings: the global endpoints, then each scale at 0
    and at 0.3 with the others at ``base``, then the finest scale alone.
    Scale 0 = the finest split (high k), L-1 = the base prior."""
    full = [base] * n_scales
    rows: list[tuple[str, list[float]]] = [(f"global_{base}", list(full)),
                                           ("global_0.0", [0.0] * n_scales)]
    for l in range(n_scales):
        for v in (0.0, 0.3):
            t = list(full)
            t[l] = v
            rows.append((f"scale{l}_{v}", t))
    only_fine = [0.0] * n_scales
    only_fine[0] = base
    rows.append(("only_scale0", only_fine))
    return rows


def band_ratios(k: np.ndarray, e_model: np.ndarray, e_ref: np.ndarray,
                n_bands: int = 4) -> list[float]:
    """log10(E_model / E_ref) averaged over ``n_bands`` equal bands of the
    upper half of the wavenumbers."""
    n = len(k)
    edges = np.linspace(n // 2, n, n_bands + 1).astype(int)
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        num = float(np.mean(e_model[a:b])) + 1e-30
        den = float(np.mean(e_ref[a:b])) + 1e-30
        out.append(float(np.log10(num / den)))
    return out


def run_probe(cfg: CaseConfig, n_members: int = 8, steps: int = 32, device="cuda") -> list[dict]:
    model, norm, _ = load_eval_bundle(cfg, device=device)
    dev = model.device
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    t_cal = min(steps, ds.n_steps)
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # The converged reference trajectory, as the evaluator builds it.
    if cfg.data.synthetic and cfg.eval.ref_steps > t_cal:
        _, hf_long = generate_case(
            cfg.data.case, ds.n_traj, cfg.eval.ref_steps, cfg.model.hf_shape,
            cfg.model.lf_shape, seed=cfg.data.seed + 10_000,
            fixture_version=cfg.data.fixture_version)
        hf_ref = on_dev(hf_long[0])
    else:
        hf_ref = on_dev(ds.denorm_hf(ds.hf[0, :t_cal]))
    hf_short = on_dev(ds.denorm_hf(ds.hf[0, :t_cal]))

    domain = (cfg.data.domain_y, cfg.data.domain_x)
    ref_fluct = hf_ref[..., :2] - hf_ref[..., :2].mean(dim=0, keepdim=True)
    k, e_ref = energy_spectrum(ref_fluct, domain, taper=True)
    tke_ref = tke_field(hf_ref.var(dim=0, correction=0))

    rollout = make_ensemble_rollout(model, n_members, collect="fields")
    lf0 = on_dev(ds.lf[0, :t_cal])
    rows = []
    for name, taus in tau_grid(cfg.eval.temperature, cfg.model.n_scales):
        f = rollout(lf0, torch.Generator(dev).manual_seed(0),
                    torch.tensor(taus, dtype=torch.float32, device=dev))  # (T, N, H, W, C)
        members = ds.denorm_hf(f).movedim(1, 0)  # (N, T, H, W, C) physical
        fluct = members[..., :2] - members[..., :2].mean(dim=(0, 1), keepdim=True)
        _, e_m = energy_spectrum(fluct, domain, taper=True)
        # Pooled (time x ensemble) variance: the evaluator's
        # total_variance(mean_t, var_t).
        tke_pred = tke_field(members.reshape(-1, *members.shape[2:]).var(dim=0, correction=0))
        row = {
            "setting": name,
            "taus": taus,
            "spectrum_rel_l2": float(relative_l2(torch.log(e_m[1:] + 1e-20),
                                                 torch.log(e_ref[1:] + 1e-20))),
            "band_log10_ratio": band_ratios(k.cpu().numpy(), e_m.cpu().numpy(),
                                            e_ref.cpu().numpy()),
            "field_rel_l2": float(relative_l2(members.mean(dim=0), hf_short)),
            "tke_rel_l2_raw": float(relative_l2(tke_pred, tke_ref)),
            "finite_frac": float(torch.isfinite(f).double().mean()),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    cfg, device = parse_args(sys.argv[1:] if argv is None else argv, prog=PROG)
    rows = run_probe(cfg, device=device)
    out_dir = pathlib.Path(cfg.eval.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "spectrum_probe.json"
    path.write_text(json.dumps(rows, indent=1))
    print(f"wrote {path}")
    return rows


cli = as_console_script(main)

if __name__ == "__main__":
    main()
