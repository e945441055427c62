"""Sampling-stability probe: where do high-tau rollouts go non-finite?

Counterpart of ``tpuflow/tools/probe_tau_stability.py``. It rolls out a
small ensemble of the case's checkpoint (fields mode) at a grid of taus x
seeds, with and without truncated latent draws (``model.z_clip``), and
reports the first non-finite step and the per-step max|y| of the finite
values. The two failure modes differ in that signature:

  * max|y| growing, then overflow: divergence through the autoregressive
    loop (state feedback);
  * non-finite values while the finite ones stay O(1): overflow inside
    one step's reverse coupling cascade, which no sampling-side guard
    fixes.

Seed s draws from ``torch.Generator(device).manual_seed(s)``.

Usage:
  python -m tpuflow_torch.tools.probe_tau_stability <case> \\
      [taus=1.0,1.15] [clips=0,4] [seeds=3] [key=value ...] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from tpuflow_torch.cli import as_console_script, parse_args, pop_tool_args
from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import load_dataset
from tpuflow_torch.eval.loading import load_eval_bundle
from tpuflow_torch.eval.rollout import make_ensemble_rollout

PROG = "python -m tpuflow_torch.tools.probe_tau_stability"


def probe(cfg: CaseConfig, taus, z_clip: float, seeds: int, device="cuda") -> list[dict]:
    """One config + z_clip setting; returns per-(tau, seed) rows."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, z_clip=z_clip))
    model, norm, _ = load_eval_bundle(cfg, device=device)
    dev = model.device
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    T = min(cfg.eval.rollout_steps, ds.n_steps)
    rollout = make_ensemble_rollout(model, cfg.eval.n_samples, collect="fields")
    lf = torch.from_numpy(ds.lf[0, :T]).to(dev)
    rows = []
    for tau in taus:
        for seed in range(seeds):
            ys = rollout(lf, torch.Generator(dev).manual_seed(seed), float(tau)).cpu().numpy()
            axes = tuple(range(1, ys.ndim))
            finite = np.isfinite(ys).all(axis=axes)
            first_bad = int(np.argmin(finite)) if not finite.all() else -1
            mx = np.nanmax(np.abs(np.where(np.isfinite(ys), ys, np.nan)), axis=axes)
            row = {
                "z_clip": z_clip,
                "temperature": float(tau),
                "seed": seed,
                "first_nonfinite_step": first_bad,
                "max_abs_head": [round(float(v), 2) for v in mx[:4]],
                "max_abs_tail": [round(float(v), 2) for v in mx[-4:]],
            }
            rows.append(row)
            print(row, flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = pop_tool_args(argv, {"taus": "1.0,1.15", "clips": "0,4", "seeds": "3"})
    cfg, device = parse_args(argv, prog=PROG)
    rows = []
    for clip in (float(x) for x in kv["clips"].split(",")):
        rows.extend(probe(cfg, [float(x) for x in kv["taus"].split(",")], clip,
                          int(kv["seeds"]), device))
    return rows


cli = as_console_script(main)

if __name__ == "__main__":
    main()
