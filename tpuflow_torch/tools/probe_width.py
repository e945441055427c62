"""Coupling-width cost probe: the rollout's rate at coupling width 64 against 128.

Counterpart of ``tpuflow/tools/probe_width.py``. It builds the case's
64-member stats rollout at each ``model.coupling_width`` (the preset
otherwise), from a seeded init with its ActNorms initialised on the
synthetic fixture, times it on the device and prints one JSON row per
width, then each width's rate and parameter count relative to the first.
A wider coupling net changes K2's shapes (its conv_in and joint_0 widths),
so the rate ratio says what the capacity costs on the card.

Usage:
  python -m tpuflow_torch.tools.probe_width [case] [steps=60] [samples=64]
      [widths=64,128] [tau=0.7] [key=value ...] [--device cuda|cpu]

Other ``key=value`` arguments (dotted config paths) pass through to the
config, as in the JAX tool.
"""

from __future__ import annotations

import json
import sys

import torch

from tpuflow_torch.cli import as_console_script, pop_tool_args
from tpuflow_torch.configs.config import load_case, parse_cli_overrides
from tpuflow_torch.eval.rollout import make_ensemble_rollout
from tpuflow_torch.tools.sweep_members import fixture_model, median_rate

ROLLOUT_STEPS = 60
N_SAMPLES = 64
WINDOW = 4


def probe(case: str, width: int, steps: int, n_samples: int = N_SAMPLES,
          overrides: dict | None = None, tau: float = 0.7, device="cuda") -> dict:
    cfg = load_case(case, {**(overrides or {}), "model.coupling_width": width,
                           "eval.n_samples": n_samples, "eval.rollout_steps": steps})
    steps, n_samples = cfg.eval.rollout_steps, cfg.eval.n_samples
    model, lf = fixture_model(cfg, device, max(steps, WINDOW + 1))
    dev = model.device
    n_params = sum(p.numel() for p in model.parameters())
    lf_traj = torch.from_numpy(lf[0, :steps]).to(dev)
    rollout = make_ensemble_rollout(model, n_samples, tau, "stats")
    rate = median_rate(lambda i: rollout(lf_traj, torch.Generator(dev).manual_seed(1)), steps, 3)
    return {
        "case": case,
        "coupling_width": width,
        "n_params": n_params,
        "rollout_steps_per_sec": round(rate, 3),
        "rollout_steps": steps,
        "n_samples": n_samples,
        "temperature": tau,
        "backend": dev.type,
    }


def main(argv: list[str] | None = None) -> list[dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    case = argv[0] if argv and "=" not in argv[0] else "backward-step"
    kv = pop_tool_args(argv, {"steps": str(ROLLOUT_STEPS), "samples": str(N_SAMPLES),
                              "widths": "64,128", "tau": "0.7"})
    steps, samples, tau = int(kv["steps"]), int(kv["samples"]), float(kv["tau"])
    widths = [int(w) for w in kv["widths"].split(",")]
    overrides = parse_cli_overrides([a for a in argv if "=" in a])
    # Echo the resolved case first: a mistyped positional falls back to
    # backward-step, which should show before a long probe.
    print(json.dumps({"probing_case": case, "widths": widths, "tau": tau}), flush=True)
    rows = []
    for w in widths:
        row = probe(case, w, steps, samples, overrides, tau=tau, device=device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    base = rows[0]
    for row in rows[1:]:
        ratio = (row["rollout_steps_per_sec"] / base["rollout_steps_per_sec"]
                 if base["rollout_steps_per_sec"] else float("nan"))
        print(json.dumps({
            "rate_ratio_vs_first": round(ratio, 3),
            "coupling_width": row["coupling_width"],
            "param_ratio_vs_first": round(row["n_params"] / base["n_params"], 3),
        }), flush=True)
    return rows


cli = as_console_script(main)

if __name__ == "__main__":
    main()
