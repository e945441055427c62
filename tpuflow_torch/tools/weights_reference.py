"""Reference values of a committed checkpoint, for another device to check.

    python -m tpuflow_torch.tools.weights_reference [weights_dir] [--device cuda|cpu] [--write]

``weights_dir`` (default ``weights/r5_v3_deep_ft``, the flagship) is a
``train.checkpoint_dir`` of the port holding ``backward-step/ckpt_*.pt``.
Two numbers are computed from it on ``--device``:

  * the held-out bits/dim at the checkpoint's bf16 nets, in its numerics
    (its meta's ``model.use_pallas``: the default path's on every committed
    checkpoint): the test split of
    the fixture version it was trained on, the first :data:`BPD_STEPS`
    steps of its 4 trajectories, teacher-forced from a zero ConvLSTM state
    and averaged (``tools/bf16_gap.py``'s "port" number);
  * an f32 rollout of :data:`ROLLOUT_MEMBERS` members x
    :data:`ROLLOUT_STEPS` steps on the first test trajectory at the
    checkpoint's learned tau, its standard-normal draws made on the CPU
    from a ``torch.Generator`` seeded with :data:`ROLLOUT_SEED`
    (:func:`rollout_draws`) and handed in as ``eps``, so every device
    rolls out the same draws. Its ensemble mean and variance (normalized
    units) are summarized by :func:`summarize`: per step the largest
    magnitude, the mean, and the values on a grid of every
    :data:`GRID`-th pixel.

``--write`` stores them as ``<weights_dir>/reference.json`` (the
committed file is the CPU's, written with one thread); without it the
values are printed as JSON. ``chip_smoke.py`` computes both on the card
and holds them to the committed file.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
CASE = "backward-step"
FLAGSHIP = ROOT / "weights" / "r5_v3_deep_ft"
BPD_STEPS = 8
ROLLOUT_SEED, ROLLOUT_MEMBERS, ROLLOUT_STEPS = 0, 4, 4
GRID = 16


def checkpoint_meta(weights_dir) -> dict:
    """The meta of the case's latest checkpoint under ``weights_dir``."""
    from tpuflow_torch.train import Checkpointer

    ckpt = Checkpointer(pathlib.Path(weights_dir) / CASE)
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {pathlib.Path(weights_dir) / CASE}")
    return ckpt.restore(step, "cpu")["meta"]


def load(weights_dir, device, **overrides):
    """(config, model on ``device``, norm, meta) of the case's latest
    checkpoint under ``weights_dir``, the config at the fixture version and
    the coupling numerics (``model.use_pallas``) the checkpoint was trained
    with, plus ``overrides``."""
    from tpuflow_torch.configs import load_case
    from tpuflow_torch.eval import load_eval_bundle

    meta = checkpoint_meta(weights_dir)
    over = {"train.checkpoint_dir": str(weights_dir),
            "data.fixture_version": meta["config"]["data"]["fixture_version"],
            "model.use_pallas": meta["config"]["model"]["use_pallas"], **overrides}
    cfg = load_case(CASE, over)
    model, norm, meta = load_eval_bundle(cfg, device=device)
    return cfg, model, norm, meta


def heldout_bpd(weights_dir, device, steps: int = BPD_STEPS, **overrides) -> float:
    """The held-out bits/dim at the checkpoint's own dtype and numerics
    (``overrides``, key=value, may set others)."""
    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.eval import make_nll_eval

    cfg, model, norm, _ = load(weights_dir, device, **overrides)
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    bpds = make_nll_eval(model)(torch.from_numpy(ds.lf[:, :steps]).to(model.device),
                                torch.from_numpy(ds.hf[:, :steps]).to(model.device))
    return float(bpds.cpu().numpy().mean())


def rollout_draws(cfg, seed: int = ROLLOUT_SEED, n: int = ROLLOUT_MEMBERS,
                  steps: int = ROLLOUT_STEPS) -> list[list[torch.Tensor]]:
    """``eps[t][l]`` on the CPU, drawn in the order the rollout draws them
    (the base prior, scale L-1, first) from a generator seeded ``seed``."""
    from tpuflow_torch.models import latent_shapes

    gen = torch.Generator().manual_seed(seed)
    shapes = latent_shapes(cfg, n)
    out = []
    for _ in range(steps):
        row = [None] * cfg.n_scales
        for l in reversed(range(cfg.n_scales)):
            row[l] = torch.randn(shapes[l], generator=gen)
        out.append(row)
    return out


def f32_rollout(weights_dir, device, seed: int = ROLLOUT_SEED, n: int = ROLLOUT_MEMBERS,
                steps: int = ROLLOUT_STEPS) -> dict[str, torch.Tensor]:
    """The f32 stats rollout on the draws of :func:`rollout_draws`:
    {"mean", "var"}, (steps, H, W, C), on the CPU."""
    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.eval import make_ensemble_rollout, resolve_temperature

    cfg, model, norm, meta = load(weights_dir, device, **{"model.compute_dtype": "float32"})
    dev = model.device
    lf = torch.from_numpy(load_dataset(cfg.data, cfg.model, "test", norm=norm).lf[0, :steps])
    eps = [[e.to(dev) for e in row] for row in rollout_draws(cfg.model, seed, n, steps)]
    tau = resolve_temperature(cfg, meta, device=dev)
    out = make_ensemble_rollout(model, n, tau, "stats")(lf.to(dev), eps=eps)
    return {k: v.cpu() for k, v in out.items()}


def summarize(stats: dict[str, torch.Tensor]) -> dict:
    """Per key and step: ``max_abs``, ``mean`` and the ``grid`` values
    (every GRID-th pixel in both directions, all channels), as lists."""
    out = {}
    for k, v in stats.items():
        a = v.double().numpy()
        out[k] = {"max_abs": np.abs(a).max(axis=(1, 2, 3)).tolist(),
                  "mean": a.mean(axis=(1, 2, 3)).tolist(),
                  "grid": a[:, ::GRID, ::GRID].reshape(a.shape[0], -1).tolist()}
    return out


def reference(weights_dir=FLAGSHIP, device="cuda") -> dict:
    """The values ``--write`` stores, computed on ``device``."""
    from tpuflow_torch.device import resolve_device

    dev = resolve_device(device)
    with torch.no_grad():
        return {
            "case": CASE,
            "bpd": {"steps": BPD_STEPS, "dtype": "bfloat16",
                    "use_pallas": checkpoint_meta(weights_dir)["config"]["model"]["use_pallas"],
                    "value": heldout_bpd(weights_dir, dev)},
            "rollout": {"dtype": "float32", "seed": ROLLOUT_SEED, "n_samples": ROLLOUT_MEMBERS,
                        "steps": ROLLOUT_STEPS, "grid": GRID,
                        "stats": summarize(f32_rollout(weights_dir, dev))},
        }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights_dir", nargs="?", default=str(FLAGSHIP),
                    help="a train.checkpoint_dir of the port (default: the flagship)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--write", action="store_true",
                    help="write <weights_dir>/reference.json (CPU, one thread)")
    args = ap.parse_args(argv)
    if args.write:
        if args.device != "cpu":
            raise SystemExit("--write stores the CPU's values: pass --device cpu")
        torch.set_num_threads(1)
    ref = reference(args.weights_dir, args.device)
    text = json.dumps(ref, indent=1)
    if args.write:
        (pathlib.Path(args.weights_dir) / "reference.json").write_text(text + "\n")
    print(text if not args.write else f"wrote {args.weights_dir}/reference.json")
    return ref


if __name__ == "__main__":
    main()
