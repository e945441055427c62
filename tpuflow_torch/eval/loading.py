"""Checkpoint loading for a rollout or an evaluation.

Counterpart of ``tpuflow/eval/loading.py``. It reads the port's own
checkpoint (``train/checkpoint.py``: ``ckpt_{step:08d}.pt`` under
``train.checkpoint_dir/<case>``), written by the port's trainer or, from
a JAX Orbax checkpoint, by ``tools/export_to_torch.py``; only its
"model", "norm" and "meta" entries are read. A missing checkpoint is a
hard error unless ``eval.allow_untrained`` is set: a typo'd
checkpoint_dir must not silently give an untrained model's
plausible-looking numbers.

The meta stays a plain dict. A JAX checkpoint's meta config holds keys
the port's strict config does not know (``data.loader``,
``train.fused_windows``, ``train.mesh_data``, ...; its ``finetune``
section has the port's ``FinetuneConfig`` fields, and a fine-tuned
checkpoint's meta adds the ``finetune`` summary of
``tools/finetune.py``); only ``meta["config"]["data"]["fixture_version"]``,
``meta["config"]["model"]["use_pallas"]`` and ``meta["learned_tau"]`` are
read from it.

The model is built from the caller's config, as the JAX package builds
it, so ``model.use_pallas`` (the coupling's numerics) is the config's. A
checkpoint trained in the other numerics than the config asks for gets a
loud warning: its bits/dim and samples would be another model's than the
one that was trained and evaluated.
"""

from __future__ import annotations

import pathlib

import torch

from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import NormStats
from tpuflow_torch.device import resolve_device
from tpuflow_torch.models.tmglow import TMGlow
from tpuflow_torch.train.checkpoint import Checkpointer


def load_eval_bundle(
    cfg: CaseConfig, step: int | None = None, device: str | torch.device = "cuda"
) -> tuple[TMGlow, NormStats | None, dict]:
    """Returns (model on ``device``, norm stats or None, checkpoint meta).

    ``step`` defaults to the latest. The meta is the dict saved with the
    checkpoint ({} for a fresh init); it may carry the fine-tuned
    per-scale temperature ``learned_tau``, which
    :func:`resolve_temperature` reads.
    """
    dev = resolve_device(device)
    model = TMGlow(cfg.model, device=dev, seed=cfg.train.seed)
    ckpt_dir = pathlib.Path(cfg.train.checkpoint_dir) / cfg.name
    ckpt = Checkpointer(ckpt_dir)
    if ckpt.latest_step() is None:
        if not cfg.eval.allow_untrained:
            raise FileNotFoundError(
                f"no checkpoint under {ckpt_dir}: refusing to evaluate an untrained "
                "model (its numbers would look plausible but mean nothing). Check "
                "train.checkpoint_dir, or pass eval.allow_untrained=true for an "
                "explicit untrained smoke run."
            )
        print(f"no checkpoint under {ckpt_dir}; using fresh init (eval.allow_untrained=true)")
        return model, None, {}

    actual_step = ckpt.latest_step() if step is None else step
    if not ckpt.path(actual_step).exists():
        raise FileNotFoundError(f"no checkpoint step {actual_step} under {ckpt_dir} "
                                f"(steps: {ckpt.steps()})")
    restored = ckpt.restore(actual_step, map_location="cpu")
    model.load_state_dict(restored["model"])
    norm = NormStats.from_dict(restored["norm"])
    print(f"loaded checkpoint step {actual_step} from {ckpt_dir}")
    meta = dict(restored.get("meta") or {})
    # A checkpoint evaluated against another synthetic fixture than it was
    # trained on gives plausible garbage. A loud warning, not an error:
    # cross-fixture evaluation is a legitimate explicit experiment.
    ckpt_fx = ((meta.get("config") or {}).get("data") or {}).get("fixture_version")
    if cfg.data.synthetic and ckpt_fx is not None and ckpt_fx != cfg.data.fixture_version:
        print(
            f"WARNING: checkpoint was trained on fixture v{ckpt_fx} but this evaluation "
            f"generates fixture v{cfg.data.fixture_version}: pass "
            f"data.fixture_version={ckpt_fx} unless the cross-fixture comparison is "
            "intentional"
        )
    ckpt_pallas = ((meta.get("config") or {}).get("model") or {}).get("use_pallas")
    if ckpt_pallas is not None and bool(ckpt_pallas) != cfg.model.use_pallas:
        print(
            f"WARNING: checkpoint was trained with model.use_pallas={bool(ckpt_pallas)} but "
            f"this run computes the coupling with model.use_pallas={cfg.model.use_pallas} "
            "(the other numerics): pass "
            f"model.use_pallas={str(bool(ckpt_pallas)).lower()} unless the comparison is "
            "intentional"
        )
    return model, norm, meta


def resolve_temperature(cfg: CaseConfig, meta: dict, device: str | torch.device = "cuda"):
    """The sampling temperature deployed for a checkpoint.

    Priority: the explicit ``eval.temperature_scales`` override (comma
    list, scale 0 = the finest split) > the checkpoint's fine-tuned
    ``learned_tau`` > the scalar ``eval.temperature``. Returns a float or
    an (L,) float32 tensor on ``device`` (the model's; the Glow's reverse
    takes either).
    """
    L = cfg.model.n_scales
    if cfg.eval.temperature_scales:
        vals = [float(v) for v in cfg.eval.temperature_scales.split(",")]
        if len(vals) != L:
            raise ValueError(
                f"eval.temperature_scales needs {L} comma-separated values (one per "
                f"scale), got {cfg.eval.temperature_scales!r}"
            )
        return torch.tensor(vals, dtype=torch.float32, device=device)
    learned = meta.get("learned_tau")
    if learned is not None:
        if len(learned) != L:
            raise ValueError(
                f"checkpoint learned_tau has {len(learned)} entries but the model has "
                f"{L} scales: config/checkpoint mismatch"
            )
        return torch.tensor([float(v) for v in learned], dtype=torch.float32, device=device)
    return cfg.eval.temperature
