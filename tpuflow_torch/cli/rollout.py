"""Autoregressive ensemble rollout from a checkpoint.

Usage: python -m tpuflow_torch.cli.rollout <case> [key=value ...] [--device cuda|cpu]

Loads the case's checkpoint from ``train.checkpoint_dir/<case>`` (the
port's trainer writes one; ``tools/export_to_torch.py`` converts a JAX
one), resolves the deployed temperature (``eval.temperature_scales`` >
the checkpoint's ``learned_tau`` > ``eval.temperature``) and rolls the
model ``eval.rollout_steps`` steps with ``eval.n_samples`` members over
the first test-split LF trajectory, once as a warm-up and once timed. A
horizon longer than the stored trajectory wrap-tiles the LF input. It
writes to ``eval.output_dir/<case>``:

  * ``rollout_stats.npz``: the ensemble ``mean`` and ``var`` in physical
    units, (T, H, W, C), and ``var_calibrated`` when ``eval.spread_scale``
    or ``eval.spread_field`` is set;
  * ``rollout_metrics.json``: ``rollout_steps_per_sec`` (and its
    ``_seconds``), ``steps``, ``n_samples``, ``temperature``, ``backend``
    (the torch device type).

The JAX CLI's figures (prediction panels, TKE, profiles, probes,
vorticity, the samples grid) need the port of ``eval/plots.py`` and
``eval/stats.py``, which has not come yet; this CLI writes none.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from tpuflow_torch.cli import parse_args
from tpuflow_torch.data.dataset import load_dataset
from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
from tpuflow_torch.eval.rollout import make_ensemble_rollout


def main(argv: list[str] | None = None) -> dict:
    cfg, device = parse_args(argv, prog="python -m tpuflow_torch.cli.rollout")
    model, norm, meta = load_eval_bundle(cfg, device=device)
    dev = model.device
    temperature = resolve_temperature(cfg, meta, device=dev)
    # The checkpoint's normalization constants are authoritative.
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    T, n_avail = cfg.eval.rollout_steps, ds.n_steps
    # A horizon beyond the stored trajectory wrap-tiles the LF input only
    # (periodic replay conditioning for long-horizon throughput runs).
    if T > n_avail:
        lf_traj = np.concatenate([ds.lf[0]] * -(-T // n_avail), axis=0)[:T]
        print(f"note: rollout horizon {T} > stored {n_avail} steps; LF input wrap-tiled")
    else:
        lf_traj = ds.lf[0, :T]

    rollout = make_ensemble_rollout(model, cfg.eval.n_samples, temperature, "stats",
                                    overflow_redraw=cfg.eval.overflow_redraw)
    lf_dev = torch.from_numpy(lf_traj).to(dev)

    def run(seed):
        out = rollout(lf_dev, torch.Generator(dev).manual_seed(seed))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    run(0)  # warm-up: cuDNN plans, the allocator, the kernel's first build
    t0 = time.perf_counter()
    out = run(1)
    dt = time.perf_counter() - t0
    metrics: dict = {"rollout_steps_per_sec": T / dt, "rollout_steps_per_sec_seconds": dt}

    out_dir = pathlib.Path(cfg.eval.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    mean = ds.denorm_hf(out["mean"].cpu().numpy())
    var = ds.denorm_hf_var(out["var"].cpu().numpy())
    # Post-hoc spread inflation applies to the predictive-uncertainty
    # surfaces only: the per-location field if set, else the scalar.
    if cfg.eval.spread_field:
        s_field = np.load(cfg.eval.spread_field)
        if s_field.shape != var.shape[-3:]:
            raise ValueError(
                f"eval.spread_field shape {s_field.shape} does not match the (H, W, C) "
                f"field shape {var.shape[-3:]}"
            )
        var_cal = var * s_field**2
    else:
        var_cal = var * cfg.eval.spread_scale**2
    stats_out = {"mean": mean, "var": var}
    if cfg.eval.spread_field or cfg.eval.spread_scale != 1.0:
        stats_out["var_calibrated"] = var_cal
    np.savez_compressed(out_dir / "rollout_stats.npz", **stats_out)

    metrics.update(
        steps=T,
        n_samples=cfg.eval.n_samples,
        # A per-scale (fine-tuned or overridden) tau serializes as a list.
        temperature=(temperature.tolist() if isinstance(temperature, torch.Tensor)
                     else float(temperature)),
        backend=dev.type,
    )
    (out_dir / "rollout_metrics.json").write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
