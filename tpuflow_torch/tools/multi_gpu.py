"""Time the port's multi-GPU paths against one GPU, on every visible card.

    python -m tpuflow_torch.tools.multi_gpu [--case backward-step] [--steps 16]
                                            [--members 64 1024] [--epochs 2]
                                            [--device cuda|cpu] [--cpu-ranks 4]
                                            [key=value ...]

Run on a host with N >= 2 GPUs; each measurement stands beside its
one-card counterpart from the same call, with the cards' names and power
limits (``nvidia-smi``):

* the member split, ``make_ensemble_rollout(mesh=)``, which the rollout
  CLI runs on such a host: the case's model at full width from a seeded
  init (perturbed as in ``profile_rollout``), ``n`` members for each of
  ``--members``, flat on the first card and split over all N. The split
  is held to the flat rollout on one generator (mean and variance within
  5e-3 x max(1, max |flat|): bf16, where each chunk's convs run at a
  smaller batch), K2's launches are counted, and both are timed flat /
  split / split / flat.
* data-parallel training, ``torchrun --nproc-per-node K -m
  tpuflow_torch.cli.train``: first at f32 on 1 and N processes at the
  same batch, where the N-process run's first window must equal the
  one-process run's: its bpd within 1e-5 relative and the norm of its
  averaged gradient within 1e-4 (the second window, after an update, is
  printed); then timed at the case's dtype on 1 and N processes at the
  same global batch, and on N at N times the batch. Each timed run prints
  its last epoch's windows/s and trajectory-windows/s (windows/s x batch).

``--device cpu`` rehearses both at a small size (give the model's widths
as key=value overrides) with ``--cpu-ranks`` CPU entries in the mesh and
ranks joined over gloo. Both parts run even if the first fails; prints
one JSON line of every number last and exits non-zero if a check failed.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

import torch

# bf16 split vs flat: only the chunks' batch sizes differ, and a conv whose
# cuDNN algorithm changes with the batch may round a feature one ulp apart.
SPLIT_TOL = 5e-3
# f32 data-parallel window vs one process on the whole batch, bpd and the
# averaged gradient's norm: they differ only in summation order (a rank
# that trained on its own rows alone is tens of percent off). Later
# windows are not held: Adam's first step is ~lr * sign(g), so a gradient
# near zero may flip the sign of its parameter's step.
DP_TOL = {"bpd": 1e-5, "grad_norm": 1e-4}
# The training fixture: 16 steps, window 8, log every window.
TRAIN_ARGS = ["data.train_steps=16", "data.window=8", "train.log_every=1", "data.synthetic=true"]


def cards() -> str:
    """The cards' names and power limits, one line each, as nvidia-smi
    gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def split_rollout(cfg, devices, n: int, steps: int, temperature: float) -> dict:
    """The member split of ``n`` members over ``devices`` against the flat
    rollout on the first, held and timed."""
    from tpuflow_torch.eval import make_ensemble_rollout
    from tpuflow_torch.kernels import coupling_fused
    from tpuflow_torch.models import TMGlow, perturb_
    from tpuflow_torch.train import make_mesh

    dev0 = devices[0]
    model = TMGlow(cfg, device=dev0, seed=0)
    perturb_(model, 1)
    gen = torch.Generator().manual_seed(14)
    lf = torch.randn(steps, *cfg.lf_shape, cfg.channels, generator=gen).to(dev0)
    flat = make_ensemble_rollout(model, n, temperature)
    split = make_ensemble_rollout(model, n, temperature,
                                  mesh=make_mesh(1, len(devices), devices=devices))
    draws = lambda seed: torch.Generator(dev0).manual_seed(seed)  # noqa: E731
    coupling_fused.launches = 0
    got = split(lf, draws(15))
    sync(devices)
    launches = coupling_fused.launches
    want = flat(lf, draws(15))
    # A member that overflows does so in both: the same entries must be
    # non-finite, and the rest agree.
    same = all(torch.equal(torch.isfinite(got[k]), torch.isfinite(want[k])) for k in want)
    fin = {k: torch.isfinite(want[k]) for k in want}
    err = max((got[k][fin[k]] - want[k][fin[k]]).abs().max().item()
              / max(1.0, want[k][fin[k]].abs().max().item()) for k in want)
    bad = sum(int((~f).sum()) for f in fin.values())
    per_step = cfg.n_scales * cfg.n_flow_steps
    expected = per_step * steps * len(devices) if dev0.type == "cuda" else 0
    print(f"  {n} members x {steps} steps over {len(devices)} devices vs flat on one, one "
          f"generator: err x max(1, max |flat|) {err:.3e} (tol {SPLIT_TOL}); non-finite stats "
          f"{bad} in the flat run, at the same entries in the split: {same}; K2 launches "
          f"{launches} (expected {expected})", flush=True)
    if not (same and err <= SPLIT_TOL and launches == expected):
        raise SystemExit(f"multi_gpu: the {n}-member split disagrees with the flat rollout")
    rates: dict[str, list[float]] = {"flat": [], "split": []}
    for name in ("flat", "split", "split", "flat"):
        sync(devices)
        t0 = time.perf_counter()
        (flat if name == "flat" else split)(lf, draws(16))
        sync(devices)
        rates[name].append(steps / (time.perf_counter() - t0))
    print(f"  steps/s flat / split / split / flat: {rates['flat'][0]} / {rates['split'][0]} / "
          f"{rates['split'][1]} / {rates['flat'][1]}", flush=True)
    return {"members": n, "devices": len(devices), "max_rel_err": err, "non_finite": bad,
            "launches": launches,
            "steps_per_sec_flat": rates["flat"], "steps_per_sec_split": rates["split"]}


def torchrun(procs: int, args: list[str], workdir: str, device: str) -> dict:
    """One ``cli.train`` run under torchrun on ``procs`` processes; returns
    its last epoch's metrics and the bpd and gradient norm of every
    logged window."""
    out = os.path.join(workdir, "final.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={procs}", "-m", "tpuflow_torch.tools.multi_gpu",
           "--train-worker", out, *args, f"train.checkpoint_dir={workdir}", "--device", device]
    # The processes import this checkout's package, from any directory.
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=1200)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", flush=True)
        raise SystemExit(f"multi_gpu: torchrun on {procs} processes exited {proc.returncode}")
    with open(out) as f:
        final = json.load(f)
    case = args[0]
    with open(os.path.join(workdir, case, "train_log.csv")) as f:
        rows = [r for r in csv.DictReader(f) if r["bpd"]]
    for key in DP_TOL:
        final[key] = [float(r[key]) for r in rows]
    return final


def train_worker(argv: list[str]) -> None:
    """A torchrun process: the training CLI's ``main``; rank 0 writes its
    last epoch's metrics, unrounded, to ``argv[0]``."""
    from tpuflow_torch.cli.train import main as train_main

    final = train_main(argv[1:])
    if os.environ.get("RANK", "0") == "0":
        with open(argv[0], "w") as f:
            json.dump(final, f)


def data_parallel(case: str, procs: int, overrides: list[str], epochs: int,
                  device: str) -> dict:
    """The f32 hold, then the timed runs (see the module docstring)."""
    res: dict = {}
    with tempfile.TemporaryDirectory(prefix="multi_gpu_") as tmp:
        f32 = [case, *TRAIN_ARGS, *overrides, "model.compute_dtype=float32",
               "data.n_train_traj=8", "data.batch_size=8", "train.epochs=1"]
        one = torchrun(1, f32, f"{tmp}/f32_1", device)
        many = torchrun(procs, f32, f"{tmp}/f32_{procs}", device)
        for key, tol in DP_TOL.items():
            errs = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(many[key], one[key])]
            print(f"  f32 windows, {procs} processes vs 1 on batch 8: {key} {many[key]} vs "
                  f"{one[key]}, rel err {errs} (tol {tol} on the first)", flush=True)
            if not errs or errs[0] > tol:
                raise SystemExit(f"multi_gpu: the data-parallel f32 window's {key} disagrees "
                                 "with one process")
            res[f"f32_{key}_rel_err"] = errs
        timed = [case, *TRAIN_ARGS, *overrides, f"data.n_train_traj={8 * procs}",
                 f"train.epochs={epochs}"]
        for k, batch in ((1, 8), (procs, 8), (procs, 8 * procs)):
            run = torchrun(k, [*timed, f"data.batch_size={batch}"], f"{tmp}/{k}_{batch}", device)
            rate = run["windows_per_sec"]
            print(f"  {k} process(es), global batch {batch}: {rate} windows/s, "
                  f"{rate * batch} trajectory-windows/s (last of {epochs} epochs, mean bpd "
                  f"{run['mean_bpd']})", flush=True)
            res[f"procs{k}_batch{batch}"] = {"windows_per_sec": rate,
                                             "traj_windows_per_sec": rate * batch,
                                             "mean_bpd": run["mean_bpd"]}
    return res


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--train-worker"]:
        train_worker(argv[1:])
        return {}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="backward-step")
    ap.add_argument("--steps", type=int, default=16, help="rollout steps (default 16)")
    ap.add_argument("--members", type=int, nargs="+", default=[64, 1024],
                    help="ensemble sizes of the split (default 64 1024)")
    ap.add_argument("--epochs", type=int, default=2, help="epochs of each timed training run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (a rehearsal)")
    ap.add_argument("--cpu-ranks", type=int, default=4, help="mesh entries with --device cpu")
    ap.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = ap.parse_intermixed_args(argv)

    from tpuflow_torch.configs import load_case, parse_cli_overrides

    if args.device == "cpu":
        devices = [torch.device("cpu")] * args.cpu_ranks
    else:
        from tpuflow_torch.device import resolve_device

        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if len(devices) < 2:
            raise SystemExit(f"multi_gpu: needs 2 or more GPUs, found {len(devices)}")
    cfg = load_case(args.case, parse_cli_overrides(args.overrides))
    res: dict = {"cards": cards(), "split": [], "failed": []}
    print(res["cards"], flush=True)

    def part(title, fn, *a):
        print(f"== {title}", flush=True)
        try:
            return fn(*a)
        except Exception as e:  # noqa: BLE001 - reported, and the exit is non-zero
            traceback.print_exc()
            res["failed"].append(f"{title}: {e!r}")
        except SystemExit as e:
            res["failed"].append(f"{title}: {e}")
        return None

    for n in args.members:
        got = part(f"member split, {n} members over {len(devices)} devices", split_rollout,
                   cfg.model, devices, n, args.steps, cfg.eval.temperature)
        if got is not None:
            res["split"].append(got)
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()  # the training processes share these cards
    res["train"] = part(f"data-parallel training on {len(devices)} processes", data_parallel,
                        args.case, len(devices), args.overrides, args.epochs, args.device)
    print(json.dumps(res), flush=True)
    if res["failed"]:
        raise SystemExit("multi_gpu: failed: " + "; ".join(res["failed"]))
    return res


if __name__ == "__main__":
    main()
