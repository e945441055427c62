"""Rollout throughput against the ensemble width N.

Counterpart of ``tpuflow/tools/sweep_members.py``. The members are the
batch of every conv and of K2 in a rollout step, so the step's cost grows
less than linearly in N while the host's launches dominate it:
member-steps/s is the efficiency readout. The tool measures the
steady-state rollout rate for each N on the device, printing one JSON
row per width, and writes them to ``{eval.output_dir}/{case}/members_sweep.json``.

Throughput only: the parameters are a seeded init (ActNorm initialised
from the synthetic fixture's first frame, as the JAX tool's
``model.init``), and the LF input is the synthetic fixture, so no dataset
or checkpoint is needed. Each rate is the median of ``repeats`` timed
rollouts after a warm-up, each ended by ``torch.cuda.synchronize()``.

Usage:
  python -m tpuflow_torch.tools.sweep_members <case> \\
      [members=32,64,96,128] [steps=100] [repeats=3] [key=value ...] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np
import torch

from tpuflow_torch.cli import as_console_script, parse_args, pop_tool_args
from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.synthetic import generate_case
from tpuflow_torch.device import resolve_device
from tpuflow_torch.eval.rollout import make_ensemble_rollout
from tpuflow_torch.models.tmglow import TMGlow, init_lstm_state
from tpuflow_torch.utils.profiling import force_completion

PROG = "python -m tpuflow_torch.tools.sweep_members"


def fixture_model(cfg: CaseConfig, device, fixture_steps: int = 2,
                  seed: int = 0) -> tuple[TMGlow, np.ndarray]:
    """A seeded init whose ActNorms are initialised from the first frame
    of a synthetic trajectory of the case (``fixture_steps`` long, seed
    ``seed``), as the JAX tools' ``model.init`` on it; returns the model
    and the trajectory's LF (1, T, h, w, C)."""
    dev = resolve_device(device)
    model = TMGlow(cfg.model, device=dev, seed=0)
    lf, hf = generate_case(cfg.name, 1, fixture_steps, cfg.model.hf_shape, cfg.model.lf_shape,
                           seed=seed, fixture_version=cfg.data.fixture_version)
    model.data_init(torch.from_numpy(hf[:, 0]).to(dev), torch.from_numpy(lf[:, 0]).to(dev),
                    init_lstm_state(cfg.model, 1, dev))
    return model, lf


def median_rate(run, n_units: int, repeats: int) -> float:
    """Median units/s of ``repeats`` calls ``run(i)`` after a warm-up call
    ``run(-1)``, each timed to the completion of its output."""
    force_completion(run(-1))
    rates = []
    for i in range(repeats):
        t0 = time.perf_counter()
        force_completion(run(i))
        rates.append(n_units / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def sweep(cfg: CaseConfig, members, steps: int, repeats: int = 3,
          device="cuda") -> list[dict]:
    """Median steady-state rollout rates for each ensemble width."""
    model, _ = fixture_model(cfg, device)
    dev = model.device
    n_fixture = max(2, min(64, steps))
    lf = generate_case(cfg.name, 1, n_fixture, cfg.model.hf_shape, cfg.model.lf_shape,
                       seed=1)[0][0]
    lf_traj = torch.from_numpy(np.concatenate([lf] * (1 + (steps - 1) // n_fixture))[:steps])
    lf_traj = lf_traj.to(dev)
    rows = []
    for n in members:
        # Stats need N >= 2; the N = 1 leg measures the single-sample
        # fields rollout instead, as the JAX tool does.
        fn = make_ensemble_rollout(model, int(n), 0.7, "stats" if n >= 2 else "fields")
        rate = median_rate(
            lambda i: fn(lf_traj, torch.Generator(dev).manual_seed(1 + i)), steps, repeats)
        row = {"members": int(n), "steps_per_sec": round(rate, 3),
               "member_steps_per_sec": round(rate * n, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = pop_tool_args(argv, {"members": "32,64,96,128", "steps": "100", "repeats": "3"})
    cfg, device = parse_args(argv, prog=PROG)
    members = tuple(int(x) for x in kv["members"].split(","))
    rows = sweep(cfg, members, int(kv["steps"]), int(kv["repeats"]), device)
    out_dir = pathlib.Path(cfg.eval.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "members_sweep.json").write_text(json.dumps(rows, indent=2))
    return rows


cli = as_console_script(main)

if __name__ == "__main__":
    main()
