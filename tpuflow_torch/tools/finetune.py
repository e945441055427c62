"""Sample-path fine-tune tool (the objectives of ``train/finetune.py``).

    python -m tpuflow_torch.tools.finetune <case> [key=value ...] [--device cuda|cpu]

Counterpart of ``tpuflow/tools/finetune.py``, step for step. It loads a
converged checkpoint of the port (``finetune.source_dir``, else
``train.checkpoint_dir``; a trainer checkpoint or a file of
``tools/export_to_torch.py``), fine-tunes it on the composite NLL +
dispersion (fair CRPS) + spectral-shape + spread-skill objective on
generative draws, optionally learning a per-scale sampling temperature,
and saves a new checkpoint (the source is never written) whose meta
carries the fitted ``learned_tau``: the rollout CLI and the evaluator
deploy it (``eval/loading.resolve_temperature``).

The output, ``{finetune.checkpoint_dir or source + "_ft"}/<case>/
ckpt_{epochs:08d}.pt``, is a checkpoint in the port's trainer format:
"model" and "norm" from the run, "optimizer" and "scheduler" from a fresh
``train.step.make_optimizer`` (so the port's trainer can resume from it),
"meta" the source meta plus ``learned_tau`` and the ``finetune``
summary. Per epoch a row goes to ``<out>/<case>_finetune_log.csv``; the
last line of standard output is the summary as JSON.

The training split lives on the device and batches are gathered there
by index. Each batch's draws come from a ``torch.Generator`` on the
device seeded with ``finetune.seed + epoch * 1000 + batch``.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

from tpuflow_torch.cli import as_console_script

PROG = "python -m tpuflow_torch.tools.finetune"
LOG_HEADER = "epoch,loss,bpd,crps,spec,disp,tau,seconds,grad_norm,skipped_windows"


def main(argv: list[str] | None = None) -> dict:
    from tpuflow_torch.cli import parse_args
    from tpuflow_torch.configs.config import _apply_overrides
    from tpuflow_torch.data import generate_case, load_dataset
    from tpuflow_torch.device import resolve_device
    from tpuflow_torch.eval.loading import load_eval_bundle, resolve_temperature
    from tpuflow_torch.train.checkpoint import Checkpointer
    from tpuflow_torch.train.finetune import (
        _scope_mask,
        clipped_tau,
        converged_log_spectra,
        make_finetune_optimizer,
        make_finetune_trajectory_step,
    )
    from tpuflow_torch.train.step import make_optimizer

    cfg, device = parse_args(sys.argv[1:] if argv is None else argv, prog=PROG)
    dev = resolve_device(device)
    ft = cfg.finetune

    # Source checkpoint (never overwritten).
    src_cfg = cfg
    if ft.source_dir:
        src_cfg = _apply_overrides(cfg, {"train.checkpoint_dir": ft.source_dir})
    model, norm, ckpt_meta = load_eval_bundle(src_cfg, device=dev)
    if norm is None:
        raise FileNotFoundError("finetune needs a trained source checkpoint (none found)")

    ds = load_dataset(cfg.data, cfg.model, "train", norm=norm)
    b = min(ft.batch_size, ds.n_traj)

    # Converged-reference log-spectrum targets, one per train trajectory:
    # the same trajectories extended to eval.ref_steps, normalized with
    # the checkpoint's constants, spectra in normalized space.
    ref_steps = max(cfg.eval.ref_steps, cfg.data.train_steps)
    _, hf_long = generate_case(
        cfg.data.case, ds.n_traj, ref_steps, cfg.model.hf_shape, cfg.model.lf_shape,
        seed=cfg.data.seed, fixture_version=cfg.data.fixture_version,
    )
    hf_long_n = (hf_long - np.asarray(norm.hf_mean)) / np.asarray(norm.hf_std)
    spec_targets = torch.stack([
        converged_log_spectra(torch.as_tensor(hf_long_n[i], dtype=torch.float32, device=dev))
        for i in range(ds.n_traj)
    ])  # (n_traj, nbins-1)
    del hf_long, hf_long_n

    # Learned per-scale tau, initialized at the source's deployed
    # temperature (its own learned_tau when chaining fine-tunes; the
    # scalar preset otherwise).
    L = cfg.model.n_scales
    tau0 = torch.as_tensor(resolve_temperature(cfg, ckpt_meta, device=dev),
                           dtype=torch.float32, device=dev)
    log_tau = torch.log(tau0.expand(L).clone()).requires_grad_()
    opt = make_finetune_optimizer(
        model, log_tau, ft.lr, ft.grad_clip, ft.learn_tau,
        scope_mask=_scope_mask(model, ft.train_scope) if ft.train_scope != "all" else None,
    )
    step = make_finetune_trajectory_step(model, opt, cfg.data.window, ft.n_members,
                                         remat=ft.remat)

    out_dir = pathlib.Path(ft.checkpoint_dir or (src_cfg.train.checkpoint_dir.rstrip("/") + "_ft"))
    ckpt = Checkpointer(out_dir / cfg.name)
    log_path = out_dir / f"{cfg.name}_finetune_log.csv"
    out_dir.mkdir(parents=True, exist_ok=True)
    log_rows = [LOG_HEADER]

    lf_all = torch.from_numpy(ds.lf).to(dev)
    hf_all = torch.from_numpy(ds.hf).to(dev)
    rng_root = np.random.default_rng(ft.seed)
    n_batches = math.ceil(ds.n_traj / b)
    t_start = time.monotonic()
    metrics: dict = {}
    # Overflow guard: the BPTT windows per epoch bound the skipped count.
    total_windows = n_batches * (ds.lf.shape[1] // cfg.data.window)
    good_snap = None  # (epoch, host copy of the parameters, of log_tau)
    best_healthy_bpd = None
    bad_streak = 0
    early_stopped = False
    epoch_summaries = {}
    last_epoch_healthy = True
    for epoch in range(ft.epochs):
        t0 = time.monotonic()
        order = rng_root.permutation(ds.n_traj)
        ep = {k: [] for k in ("loss", "bpd", "crps", "spec", "disp", "grad_norm",
                              "skipped_windows")}
        for bi in range(n_batches):
            idx = order[bi * b: (bi + 1) * b]
            if len(idx) < b:  # static shapes: pad by wrapping
                idx = np.concatenate([idx, order[: b - len(idx)]])
            idx_d = torch.from_numpy(idx).to(dev)
            metrics = step(
                lf_all[idx_d], hf_all[idx_d], spec_targets[idx_d],
                torch.Generator(dev).manual_seed(ft.seed + epoch * 1000 + bi),
                ft.lambda_crps, ft.lambda_spec, ft.lambda_disp,
            )
            for k in ep:
                ep[k].append(float(metrics[k]))
        tau_now = [round(float(t), 4) for t in metrics["tau"].cpu()]
        row = (
            f"{epoch},{np.mean(ep['loss']):.5f},{np.mean(ep['bpd']):.5f},"
            f"{np.mean(ep['crps']):.5f},{np.mean(ep['spec']):.5f},"
            f"{np.mean(ep['disp']):.5f},"
            f"\"{tau_now}\",{time.monotonic() - t0:.1f},"
            f"{np.mean(ep['grad_norm']):.3f},{np.sum(ep['skipped_windows']):.0f}"
        )
        log_rows.append(row)
        log_path.write_text("\n".join(log_rows) + "\n")
        print(f"[finetune] {row}", flush=True)

        ep_bpd = float(np.mean(ep["bpd"]))
        epoch_summaries[epoch] = {k: float(np.mean(ep[k])) for k in ("crps", "spec", "disp")}
        epoch_summaries[epoch]["bpd"] = ep_bpd
        skip_frac = float(np.sum(ep["skipped_windows"])) / max(1, total_windows)
        healthy = skip_frac <= ft.max_skipped_frac and (
            best_healthy_bpd is None or ep_bpd <= best_healthy_bpd + ft.max_bpd_rise
        )
        last_epoch_healthy = healthy
        if healthy:
            # Host snapshot of the last healthy state: the saved checkpoint
            # rolls back here if later epochs cross the decoder's validity
            # boundary.
            good_snap = (epoch, {k: v.detach().cpu().clone()
                                 for k, v in model.state_dict().items()},
                         log_tau.detach().cpu().clone())
            best_healthy_bpd = ep_bpd if best_healthy_bpd is None else min(best_healthy_bpd,
                                                                           ep_bpd)
            bad_streak = 0
        else:
            bad_streak += 1
            print(
                f"[finetune] epoch {epoch} UNHEALTHY: skipped-window frac {skip_frac:.2f} "
                f"(max {ft.max_skipped_frac}), bpd {ep_bpd:.3f} (best healthy "
                f"{best_healthy_bpd})", flush=True,
            )
            catastrophic = (best_healthy_bpd is not None
                            and ep_bpd > best_healthy_bpd + 2 * ft.max_bpd_rise)
            if ft.early_stop and (bad_streak >= 2 or catastrophic):
                early_stopped = True
                print(
                    "[finetune] overflow boundary crossed — stopping early after epoch "
                    f"{epoch}; saving the last healthy snapshot"
                    + (f" (epoch {good_snap[0]})" if good_snap else ""), flush=True,
                )
                break

    saved_epoch = epoch
    log_tau_ft = log_tau.detach()
    if good_snap is not None and not last_epoch_healthy:
        saved_epoch, snap, log_tau_ft = good_snap
        model.load_state_dict(snap)
        print(f"[finetune] rolled back to healthy epoch {saved_epoch}", flush=True)
    elif good_snap is None:
        print("[finetune] WARNING: no healthy epoch — saving the final state anyway; "
              "inspect the log before deploying", flush=True)
    learned_tau = [float(t) for t in clipped_tau(log_tau_ft).cpu()]
    # The trainer's checkpoint format: a fresh optimizer and scheduler, so
    # the port's trainer can resume from the file.
    std_opt, std_sched = make_optimizer(model.parameters(), cfg.train.lr, cfg.train.lr_decay,
                                        cfg.train.weight_decay)
    meta = {
        **{k: v for k, v in ckpt_meta.items() if k != "learned_tau"},
        "learned_tau": learned_tau if ft.learn_tau else None,
        "finetune": {
            "epochs": ft.epochs,
            "n_members": ft.n_members,
            "lambda_crps": ft.lambda_crps,
            "lambda_spec": ft.lambda_spec,
            "lambda_disp": ft.lambda_disp,
            "train_scope": ft.train_scope,
            "lr": ft.lr,
            "source_dir": src_cfg.train.checkpoint_dir,
            # Summary of the epoch actually saved (the guard may roll back
            # to the last healthy snapshot).
            "saved_epoch": saved_epoch,
            "epochs_run": epoch + 1,
            "early_stopped": early_stopped,
            "final_bpd": epoch_summaries[saved_epoch]["bpd"],
            "final_crps": epoch_summaries[saved_epoch]["crps"],
            "final_spec": epoch_summaries[saved_epoch]["spec"],
            "final_disp": epoch_summaries[saved_epoch]["disp"],
        },
    }
    if not ft.learn_tau:
        meta.pop("learned_tau")
    ckpt.save(ft.epochs, {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": std_opt.state_dict(),
        "scheduler": std_sched.state_dict(),
        "norm": {k: torch.from_numpy(np.asarray(v, np.float32))
                 for k, v in norm.to_dict().items()},
        "meta": meta,
    })
    summary = {
        "checkpoint_dir": str(out_dir),
        "learned_tau": learned_tau if ft.learn_tau else None,
        "final_bpd": meta["finetune"]["final_bpd"],
        "final_crps": meta["finetune"]["final_crps"],
        "final_spec": meta["finetune"]["final_spec"],
        "seconds": round(time.monotonic() - t_start, 1),
    }
    print(json.dumps(summary))
    return summary


cli = as_console_script(main)

if __name__ == "__main__":
    main()
