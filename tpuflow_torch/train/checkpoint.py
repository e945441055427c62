"""Checkpoints of the full training state, in the port's own format.

Counterpart of ``tpuflow/train/checkpoint.py``: one file per step,
``{directory}/ckpt_{step:08d}.pt``, a ``torch.save`` of {"model",
"optimizer", "scheduler" state dicts, "norm" (the dataset's
normalization constants as tensors), "meta" (epoch, global_step,
config)}. Writes go to a temporary file first and are renamed into
place, so a crash never leaves a half-written step. The oldest steps
beyond ``max_to_keep`` are deleted. Files are read with
``weights_only=True``.

The JAX package's Orbax checkpoints reach this format through
``tools/export_to_torch.py`` (run where JAX is): such a file holds
"model", "norm" and "meta" but no optimizer state, so it serves a
rollout and cannot resume training.
"""

from __future__ import annotations

import os
import pathlib
import re
from typing import Any

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 3):
        self.directory = pathlib.Path(directory).absolute()
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> pathlib.Path:
        return self.directory / f"ckpt_{step:08d}.pt"

    def steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict[str, Any]) -> pathlib.Path:
        self.directory.mkdir(parents=True, exist_ok=True)
        out = self.path(step)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, out)
        for old in self.steps()[: -self.max_to_keep]:
            self.path(old).unlink(missing_ok=True)
        return out

    def restore(self, step: int | None = None, map_location=None) -> dict[str, Any] | None:
        """The state saved at ``step`` (default: the latest), or None if
        there is no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location, weights_only=True)
