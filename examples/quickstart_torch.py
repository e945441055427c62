"""End-to-end walkthrough of the PyTorch port on the procedural synthetic dataset.

The counterpart of ``examples/quickstart.py``, step for step, through
``tpuflow_torch``: train -> checkpoint -> ensemble rollout -> UQ
statistics -> recalibrated rollout -> report -> export + serve, in
miniature, with no downloads. For the production-size runs, drop the size
overrides (see ``tpuflow_torch/configs/cases/*.yaml`` for the presets).

    python examples/quickstart_torch.py [workdir] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises where there is no GPU; name
``cpu`` to run there (about a minute). The CLIs draw figures with
matplotlib; without it the walkthrough stops at its start, as they do.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

PROG = "python examples/quickstart_torch.py"


def small_args(workdir: pathlib.Path) -> list[str]:
    # The case API: one positional case name + dotted overrides, identical
    # to the CLI (`python -m tpuflow_torch.cli.train backward-step key=value ...`).
    return [
        "backward-step",
        # Miniature model so the CPU finishes in about a minute (production
        # preset: remove these lines).
        "model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
        "model.coupling_layers=2", "model.growth_rate=4",
        "model.encoder_width=8", "model.lstm_hidden=8", "model.cond_channels=8",
        "model.hf_shape=16,32", "model.lf_shape=4,8",
        # Miniature synthetic dataset (procedural: no Zenodo archives).
        "data.n_train_traj=8", "data.n_test_traj=4", "data.train_steps=8",
        "data.window=4", "data.batch_size=4",
        f"train.checkpoint_dir={workdir}/ckpt",
        f"eval.output_dir={workdir}/eval",
        "train.epochs=8", "train.checkpoint_every=4",
        "eval.rollout_steps=8", "eval.n_samples=8", "eval.calibration_steps=6",
    ]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", default="./quickstart_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from tpuflow_torch.cli import require_matplotlib
    from tpuflow_torch.device import resolve_device

    device = resolve_device(args.device).type  # raises without a GPU unless --device cpu
    require_matplotlib(PROG)
    from tpuflow_torch.cli.evaluate import main as evaluate_main
    from tpuflow_torch.cli.rollout import main as rollout_main
    from tpuflow_torch.cli.train import main as train_main
    from tpuflow_torch.tools.export_rollout import main as export_main
    from tpuflow_torch.tools.report import main as report_main
    from tpuflow_torch.tools.serve import RolloutServer

    workdir = pathlib.Path(args.workdir)
    small = small_args(workdir)
    on = ["--device", device]

    print("== 1. Train (truncated-BPTT NLL, Adam + decay, checkpoints)")
    train = train_main(small + on)
    print(f"   final mean bits/dim: {train['mean_bpd']:.3f}")

    print("== 2. Ensemble rollout (autoregressive, the fused coupling kernel on a GPU)")
    roll = rollout_main(small + on)
    print(f"   {roll['rollout_steps_per_sec']:.2f} steps/s; "
          f"figures in {workdir}/eval/backward-step/")

    print("== 3. Held-out evaluation (NLL, TKE, spectra, CRPS, coverage)")
    ev = evaluate_main(small + on)
    print(json.dumps({k: ev[k] for k in (
        "test_bpd", "field_rel_l2_mean", "tke_rel_l2_mean", "crps_mean",
        "spread_scale")}, indent=1))
    print("   held-out coverage at nominal 0.50/0.80/0.90/0.95:")
    for label, key in [
        ("raw ensemble   ", "coverage_holdout_raw"),
        ("single factor  ", "coverage_holdout_single_factor"),
        ("per-level recal", "coverage_holdout_per_level"),
    ]:
        vals = "/".join(f"{v:.2f}" for v in ev[key].values())
        print(f"     {label}: {vals}")

    print("== 4. Deploy the fitted UQ recalibration for free")
    # A separate output dir keeps step 2's raw stats and figures; physics
    # TKE stays on the raw variance, the UQ surfaces get var_calibrated.
    recal = rollout_main(small + [
        f"eval.spread_scale={ev['spread_scale']}",
        f"eval.output_dir={workdir}/eval_recalibrated",
    ] + on)
    print(f"   recalibrated rollout stats written to eval_recalibrated/ "
          f"(var_calibrated = var x {ev['spread_scale']:.2f}^2)")

    print("== 5. Consolidated report (tools/report.py)")
    report = report_main(small)
    print(f"   one-page markdown summary of the run: {report}")

    print("== 6. Export + serve (torch.export artifact, no model code needed)")
    # Exported for the device this process serves on: the loader refuses
    # another device or torch version.
    artifact = export_main(small + on)
    server = RolloutServer(artifact, device=device)  # artifact + sidecar only
    lf_shape = tuple(server.meta["lf_input_shape"])
    served = server.rollout(  # physical-unit request, normalized server-side
        np.zeros(lf_shape, np.float32), seed=0
    )
    print(f"   served ensemble mean {served['mean'].shape} from {artifact.name} "
          "(tpuflow-torch-serve http serves the same pair over HTTP); done.")
    return {"train": train, "roll": roll, "ev": ev, "recal": recal, "report": report,
            "artifact": artifact, "served": served}


if __name__ == "__main__":
    # Run from a checkout without installing the package.
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    main()
