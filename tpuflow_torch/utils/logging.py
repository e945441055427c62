"""Structured metrics logging: an append-only CSV file plus stdout lines.

Counterpart of ``tpuflow/utils/logging.py`` without TensorBoard. The CSV
schema is fixed by the first row written; a later row's extra keys are
dropped from the file (with one warning) and still printed.
"""

from __future__ import annotations

import csv
import pathlib
import sys
import time
from typing import Any


class MetricsLogger:
    def __init__(self, path: str | pathlib.Path | None = None, quiet: bool = False):
        self._path = pathlib.Path(path) if path else None
        self._file = None
        self._writer = None
        self._fields: list[str] | None = None
        self._quiet = quiet
        self._warned: set = set()
        self._t0 = time.time()

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
        if not self._quiet:
            print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()), flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = self._writer = None


def _scalar(v: Any):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
