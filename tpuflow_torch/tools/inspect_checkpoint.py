"""Checkpoint inspector: what is in a run directory, and is it sound.

Counterpart of ``tpuflow/tools/inspect_checkpoint.py`` for the port's
checkpoints (``train/checkpoint.py``: ``ckpt_{step:08d}.pt``, read with
``weights_only=True``). It answers without a restore script: which steps
exist, what config trained them, how many values each part holds, whether
they are finite, and whether the model's shapes still match the model the
stored config builds (a drifted config shows before a long run resumes
from an incompatible checkpoint).

A trainer's checkpoint holds "model", "optimizer", "scheduler", "norm"
and "meta"; an exporter's (``tools/export_to_torch.py``) holds "model",
"norm" and "meta", with a JAX config in its meta: it is sound, serves a
rollout and cannot resume training, which the report says. The inspector
only reads: a mistyped path is reported, never created, and a file that
does not load (truncated, corrupted) is reported UNSOUND.

Usage:
  python -m tpuflow_torch.tools.inspect_checkpoint <run-dir> [--step=N] [--json]

<run-dir> is a Checkpointer directory, e.g. checkpoints/backward-step.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

import torch

from tpuflow_torch.configs.config import ModelConfig, _from_dict
from tpuflow_torch.models.tmglow import TMGlow
from tpuflow_torch.train.checkpoint import Checkpointer
from tpuflow_torch.utils.profiling import _leaves

PARTS = ("model", "optimizer", "scheduler", "norm")
SERVING_PARTS = ("model", "norm")  # what an exporter's file holds


def _tree_summary(tree) -> dict:
    leaves = list(_leaves(tree))
    return {
        "leaves": len(leaves),
        "values": int(sum(t.numel() for t in leaves)),
        "bytes": int(sum(t.numel() * t.element_size() for t in leaves)),
        "non_finite": int(sum(t.numel() - int(torch.isfinite(t).sum())
                              for t in leaves if t.is_floating_point())),
    }


def _model_config(stored: dict) -> ModelConfig:
    """The stored config's model section, keeping the fields the port's
    ``ModelConfig`` has (a JAX config holds others, such as ``use_pallas``)."""
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    return _from_dict(ModelConfig, {k: v for k, v in stored.items() if k in known})


def inspect_checkpoint(run_dir: str | pathlib.Path, step: int | None = None) -> dict:
    """Return the inspection record for one checkpoint step (the latest by
    default)."""
    run_dir = pathlib.Path(run_dir)
    if not run_dir.is_dir():
        return {"path": str(run_dir), "steps": [],
                "errors": ["run directory does not exist"], "ok": False}
    ckpt = Checkpointer(run_dir)
    steps = ckpt.steps()
    if not steps:
        return {"path": str(run_dir), "steps": steps, "errors": ["no checkpoint found"],
                "ok": False}
    step = steps[-1] if step is None else step
    try:
        state = ckpt.restore(step, map_location="cpu")
    except Exception as e:  # a corrupted save must report, not crash
        return {"path": str(run_dir), "steps": steps, "step": step,
                "errors": [f"restore failed: {type(e).__name__}: {e}"], "ok": False}
    meta = state.get("meta") or {}
    rec: dict = {
        "path": str(run_dir),
        "steps": steps,
        "step": step,
        "epoch": meta.get("epoch"),
        "global_step": meta.get("global_step"),
        "case": (meta.get("config") or {}).get("name"),
        "errors": [],
    }
    serving_only = "optimizer" not in state
    if serving_only:
        rec["note"] = ("no optimizer state: an exporter's file"
                       f" (source {meta.get('source', 'unknown')!r}); it serves a rollout and "
                       "cannot resume training")
    for part in SERVING_PARTS if serving_only else PARTS:
        if part in state:
            rec[part] = _tree_summary(state[part])
            if rec[part]["non_finite"]:
                rec["errors"].append(f"{part} contains {rec[part]['non_finite']} non-finite values")
        else:
            rec["errors"].append(f"checkpoint is missing '{part}'")
    if "norm" in state:
        rec["norm_constants"] = {k: [round(float(x), 6) for x in v.reshape(-1)]
                                 for k, v in state["norm"].items()}

    # Config <-> state consistency: build the model from the STORED config
    # and compare the shapes tensor by tensor.
    stored = (meta.get("config") or {}).get("model")
    if stored and "model" in state:
        try:
            want = {k: tuple(v.shape) for k, v in
                    TMGlow(_model_config(stored), device="cpu").state_dict().items()}
            got = {k: tuple(v.shape) for k, v in state["model"].items()}
            for k in sorted(set(want) | set(got)):
                if k not in got:
                    rec["errors"].append(f"model.{k}: missing from checkpoint")
                elif k not in want:
                    rec["errors"].append(f"model.{k}: not in model built from stored config")
                elif want[k] != got[k]:
                    rec["errors"].append(f"model.{k}: shape {got[k]} != model {want[k]}")
        except Exception as e:  # inspection must report, not crash
            rec["errors"].append(f"config-consistency check failed: {e}")

    rec["ok"] = not rec["errors"]
    return rec


def _fmt(rec: dict) -> str:
    lines = [f"checkpoint dir: {rec['path']}", f"  steps on disk: {rec.get('steps')}"]
    if "epoch" in rec:
        lines.append(f"  inspected step {rec.get('step')}: epoch {rec.get('epoch')}, "
                     f"global_step {rec.get('global_step')}, case {rec.get('case')}")
    if "note" in rec:
        lines.append(f"  note: {rec['note']}")
    for part in PARTS:
        if isinstance(rec.get(part), dict):
            s = rec[part]
            lines.append(f"  {part}: {s['values']:,} values in {s['leaves']} tensors "
                         f"({s['bytes'] / 1e6:.1f} MB)")
    for k, v in rec.get("norm_constants", {}).items():
        lines.append(f"  norm.{k}: {v}")
    for e in rec["errors"]:
        lines.append(f"  ERROR: {e}")
    lines.append("  checkpoint: " + ("OK" if rec["ok"] else "UNSOUND"))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    step, as_json, paths = None, False, []
    for a in argv:
        if a.startswith("--step="):
            step = int(a.split("=", 1)[1])
        elif a == "--json":
            as_json = True
        elif a.startswith("--"):
            raise SystemExit(f"unknown flag {a}")
        else:
            paths.append(a)
    if not paths:
        print(__doc__)
        return 2
    ok = True
    for p in paths:
        rec = inspect_checkpoint(p, step=step)
        print(json.dumps(rec) if as_json else _fmt(rec))
        ok = ok and rec["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
