"""Autoregressive ensemble rollout from a checkpoint.

Usage: python -m tpuflow_torch.cli.rollout <case> [key=value ...] [--device cuda|cpu]

Loads the case's checkpoint from ``train.checkpoint_dir/<case>`` (the
port's trainer writes one; ``tools/export_to_torch.py`` converts a JAX
one), resolves the deployed temperature (``eval.temperature_scales`` >
the checkpoint's ``learned_tau`` > ``eval.temperature``) and rolls the
model ``eval.rollout_steps`` steps with ``eval.n_samples`` members over
the first test-split LF trajectory, once as a warm-up and once timed
(traced into ``eval.trace_dir`` if set). On a host with several GPUs the
members split over all of them when ``eval.n_samples`` divides by their
count (``make_ensemble_rollout(mesh=)``), as the JAX CLI shards them;
otherwise, and on the CPU, the rollout runs flat on one device. One host
thread issues every card's launches, so the split pays only for large
ensembles: on four NVIDIA H100 80GB HBM3 (700 W) it ran 0.24x the flat
rate at 64 members and 1.4x at 1024 (``tools/multi_gpu.py``); set
``CUDA_VISIBLE_DEVICES`` to one card to run flat. A horizon longer than the
stored trajectory wrap-tiles the LF input; the HF comparisons use only
the stored frames. It writes to ``eval.output_dir/<case>``:

  * ``rollout_stats.npz``: the ensemble ``mean`` and ``var`` in physical
    units, (T, H, W, C), and ``var_calibrated`` when ``eval.spread_scale``
    or ``eval.spread_field`` is set;
  * ``rollout_metrics.json``: ``rollout_steps_per_sec`` (and its
    ``_seconds``), ``steps``, ``n_samples``, ``temperature``, ``backend``
    (the torch device type), ``devices`` (how many the members split
    over);
  * the figures of ``tpuflow/cli/rollout.py``: prediction panels at
    t in {0, t_ref/2, t_ref - 1}, TKE, profiles, probes, vorticity, and
    the member samples of a fields-mode rollout of min(8, N) members to
    t_ref/2 + 1 (generator seed 2).

``rollout()`` is the compute half, without figures; ``main()`` needs
matplotlib and stops at its start without it.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from tpuflow_torch.cli import as_console_script, parse_args, require_matplotlib
from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import load_dataset
from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
from tpuflow_torch.eval.rollout import make_ensemble_rollout
from tpuflow_torch.eval.stats import tke_field, total_variance, vorticity
from tpuflow_torch.train.mesh import make_mesh
from tpuflow_torch.utils.profiling import force_completion, step_timer, trace_context

PROG = "python -m tpuflow_torch.cli.rollout"


def visible_devices(dev: torch.device) -> list[torch.device]:
    """``dev`` first, then every other visible device of its type (the
    CPU counts as one)."""
    if dev.type != "cuda":
        return [dev]
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    others = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] + [d for d in others if d != dev]


def member_mesh(devices: list, n_samples: int):
    """The mesh that splits ``n_samples`` members over ``devices``, or None
    (run flat) with one device or where the count does not divide."""
    if len(devices) < 2 or n_samples % len(devices):
        return None
    return make_mesh(1, len(devices), devices=devices)


def rollout(cfg: CaseConfig, device: str | torch.device = "cuda") -> tuple[dict, list]:
    """Roll out the case's checkpoint; writes ``rollout_stats.npz`` and
    ``rollout_metrics.json`` and returns (metrics, figure payloads for
    ``eval.plots.draw``)."""
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
        print(f"note: rollout horizon {T} > stored {n_avail} steps; LF input wrap-tiled, HF "
              f"comparisons use the first {n_avail} genuine frames")
    else:
        lf_traj = ds.lf[0, :T]
    t_ref = min(T, n_avail)

    mesh = member_mesh(visible_devices(dev), cfg.eval.n_samples)
    run = make_ensemble_rollout(model, cfg.eval.n_samples, temperature, "stats",
                                overflow_redraw=cfg.eval.overflow_redraw, mesh=mesh)
    lf_dev = torch.from_numpy(lf_traj).to(dev)
    # Warm-up (cuDNN plans, the allocator, the kernel's first build), then
    # the timed run.
    force_completion(run(lf_dev, torch.Generator(dev).manual_seed(0)))
    metrics: dict = {}
    with trace_context(cfg.eval.trace_dir):
        with step_timer(metrics, "rollout_steps_per_sec", n_items=T) as sync:
            out = run(lf_dev, torch.Generator(dev).manual_seed(1))
            sync.append(out)

    out_dir = pathlib.Path(cfg.eval.output_dir) / cfg.name
    out_dir.mkdir(parents=True, exist_ok=True)
    mean = ds.denorm_hf(out["mean"].cpu().numpy())
    var = ds.denorm_hf_var(out["var"].cpu().numpy())
    # Post-hoc spread inflation applies to the predictive-uncertainty
    # surfaces only (variance maps, +-2 sigma bands, var_calibrated): the
    # per-location field if set, else the scalar. TKE keeps the raw
    # ensemble variance, a physical quantity.
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

    # Reference-vs-prediction figures stay within the genuine frames.
    hf_phys = ds.denorm_hf(ds.hf[0, :t_ref])
    lf_phys = ds.denorm_lf(lf_traj)
    t_mid = t_ref // 2
    figures: list = [("prediction_panels", dict(lf=lf_phys[t], hf=hf_phys[t], mean=mean[t],
                                                var=var_cal[t], t=t))
                     for t in sorted({0, t_mid, t_ref - 1})]
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    tke_pred = tke_field(total_variance(on_dev(mean[:t_ref]), on_dev(var[:t_ref])))
    tke_ref = tke_field(on_dev(hf_phys).var(dim=0, correction=0))
    gh, gw = cfg.model.hf_shape
    dx, dy = cfg.data.domain_x / gw, cfg.data.domain_y / gh
    figures += [
        ("tke", dict(tke_pred=tke_pred.cpu().numpy(), tke_ref=tke_ref.cpu().numpy())),
        ("profiles", dict(mean=mean[t_mid], std=np.sqrt(var_cal[t_mid]), hf=hf_phys[t_mid])),
        ("probe_timeseries", dict(mean=mean[:t_ref], std=np.sqrt(var_cal[:t_ref]), hf=hf_phys)),
        ("vorticity", dict(
            vort_pred=vorticity(on_dev(mean[t_ref - 1]), dx=dx, dy=dy).cpu().numpy(),
            vort_ref=vorticity(on_dev(hf_phys[t_ref - 1]), dx=dx, dy=dy).cpu().numpy(),
            t=t_ref - 1)),
    ]
    # Individual member samples: a small fields-mode rollout to t_mid + 1.
    n_show = min(8, cfg.eval.n_samples)
    fields = make_ensemble_rollout(model, n_show, temperature, "fields",
                                   overflow_redraw=cfg.eval.overflow_redraw)(
        lf_dev[: t_mid + 1], torch.Generator(dev).manual_seed(2))
    figures.append(("samples_grid", dict(samples=ds.denorm_hf(fields[-1].cpu().numpy()),
                                         hf=hf_phys[t_mid], t=t_mid)))

    metrics.update(
        steps=T,
        n_samples=cfg.eval.n_samples,
        # A per-scale (fine-tuned or overridden) tau serializes as a list.
        temperature=(temperature.tolist() if isinstance(temperature, torch.Tensor)
                     else float(temperature)),
        backend=dev.type,
        devices=1 if mesh is None else mesh.size,
    )
    (out_dir / "rollout_metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics, figures


def main(argv: list[str] | None = None) -> dict:
    """The CLI: roll out, then draw the figures; returns the metrics."""
    cfg, device = parse_args(argv, prog=PROG)
    require_matplotlib(PROG)
    from tpuflow_torch.eval.plots import draw

    metrics, figures = rollout(cfg, device)
    draw(pathlib.Path(cfg.eval.output_dir) / cfg.name, figures)
    print(json.dumps(metrics))
    return metrics


cli = as_console_script(main)

if __name__ == "__main__":
    main()
