"""Structured metrics logging: an append-only CSV file plus stdout lines.

Counterpart of ``tpuflow/utils/logging.py``. The CSV schema is fixed by
the first row written; a later row's extra keys are dropped from the file
(with one warning) and still printed. With ``tensorboard_dir`` the float
values of every row also go to TensorBoard scalar summaries through
``torch.utils.tensorboard.SummaryWriter``; where the ``tensorboard``
package is missing, the logger warns and writes CSV and stdout only.
"""

from __future__ import annotations

import csv
import os
import pathlib
import sys
import time
from typing import Any


class MetricsLogger:
    """Append-only CSV + stdout metrics stream, optional TensorBoard."""

    def __init__(
        self,
        path: str | pathlib.Path | None = None,
        quiet: bool = False,
        tensorboard_dir: str | pathlib.Path | None = None,
    ):
        self._path = pathlib.Path(path) if path else None
        self._file = None
        self._writer = None
        self._fields: list[str] | None = None
        self._quiet = quiet
        self._warned: set = set()
        self._t0 = time.time()
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("tensorboard_dir set but tensorboard unavailable; TensorBoard logging "
                      "disabled", file=sys.stderr)
            else:
                self._tb = SummaryWriter(str(tensorboard_dir))

    def log(self, step: int, **metrics: Any) -> None:
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        row.update({k: _scalar(v) for k, v in metrics.items()})
        if self._path:
            if self._writer is None:
                self._path.parent.mkdir(parents=True, exist_ok=True)
                self._file = open(self._path, "a", newline="")
                self._fields = list(row)
                self._writer = csv.DictWriter(self._file, fieldnames=self._fields)
                if self._file.tell() == 0:
                    self._writer.writeheader()
            extra = set(row) - set(self._fields) - self._warned
            if extra:
                self._warned |= extra
                print(f"MetricsLogger: dropping {sorted(extra)} from CSV (schema fixed "
                      "at the first row)", file=sys.stderr)
            self._writer.writerow({k: row.get(k, "") for k in self._fields})
            self._file.flush()
        if self._tb is not None:
            for k, v in row.items():
                if k != "step" and isinstance(v, float):
                    self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if not self._quiet:
            print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()), flush=True)

    def touch(self) -> None:
        """Advance the CSV file's mtime without writing a row. The training
        supervisor reads that mtime as the run's heartbeat; a healthy phase
        that logs no row (validation) calls this so it is not taken for a
        stalled run. A no-op before the file exists."""
        if self._path and self._path.exists():
            os.utime(self._path)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = self._writer = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _scalar(v: Any):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
