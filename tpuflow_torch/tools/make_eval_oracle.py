"""Regenerate the port's committed evaluator regression oracle.

    python -m tpuflow_torch.tools.make_eval_oracle --device cpu
    python -m tpuflow_torch.tools.make_eval_oracle --output <dir>    # on the GPU

Counterpart of ``tpuflow/tools/make_eval_oracle.py``: a small but complete
evaluation (every metric family, every calibration chain, the holdout
scoring) of a committed checkpoint, with the JAX oracle's case and
overrides (fixture v2, 4 members, 8 rollout steps, 6 calibration steps, 16
reference steps, batches of 2 trajectories). Its checkpoint is the JAX
oracle's, ``runs/r4_bstep_deeper`` step 800, through
``tools/export_to_torch.py``, committed in the port's format under
``runs/r5_eval_oracle_torch/weights``. It runs the port's
``cli.evaluate.main`` and writes ``eval_metrics.json``, the three
calibration artefacts and the figures.

**The committed oracle, ``runs/r5_eval_oracle_torch/backward-step/``, is
the CPU's**, evaluated with one thread: ``--device cpu`` without
``--output`` rewrites it, and ``tests/test_torch_evaluate.py`` holds a
fresh CPU evaluation to it. Like every entry point of the port, the tool
runs on the GPU unless asked for the CPU; a run on another device than the
CPU never writes the committed directory, only an ``--output`` the caller
names. The oracle pins code behaviour, not model quality.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]

# The full argument list is the oracle's identity; the regression test
# imports it, so the committed artefact and its re-derivation cannot drift.
ORACLE_CASE = "backward-step"
ORACLE_OUTPUT = "runs/r5_eval_oracle_torch"
ORACLE_WEIGHTS = "runs/r5_eval_oracle_torch/weights"
ORACLE_OVERRIDES = [
    "data.fixture_version=2",
    f"train.checkpoint_dir={REPO / ORACLE_WEIGHTS}",
    "eval.n_samples=4",
    "eval.rollout_steps=8",
    "eval.calibration_steps=6",
    "eval.ref_steps=16",
    "eval.traj_batch=2",
]


def oracle_args(output_dir: str | os.PathLike) -> list[str]:
    return [ORACLE_CASE, *ORACLE_OVERRIDES, f"eval.output_dir={output_dir}"]


def main(argv: list[str] | None = None) -> dict:
    import torch

    from tpuflow_torch.cli.evaluate import main as evaluate_main
    from tpuflow_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--output", default=None,
                    help="eval.output_dir to write (default, on the CPU only: the committed "
                         f"{ORACLE_OUTPUT})")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    if args.output is None and dev.type != "cpu":
        raise SystemExit(f"the committed oracle is the CPU's: pass --device cpu, or --output "
                         f"<dir> for a {dev.type} evaluation")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    out = pathlib.Path(args.output) if args.output else REPO / ORACLE_OUTPUT
    metrics = evaluate_main([*oracle_args(out), "--device", args.device])
    print(f"oracle written under {out / ORACLE_CASE}")
    return metrics


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
