"""Profiling helpers: ``torch.profiler`` traces, a timer that waits for
the device, and per-stage seconds.

Counterpart of ``tpuflow/utils/profiling.py``. A CUDA launch returns
before the kernel ends, so every clock here stops only after
``torch.cuda.synchronize()`` on the devices of the outputs it was given.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time

import torch


@contextlib.contextmanager
def trace_context(trace_dir: str | None):
    """Record a ``torch.profiler`` trace of the block (host, and the GPU
    where there is one) and write it as a Chrome trace
    ``trace_<pid>_<time>.json`` into ``trace_dir``; a no-op for None or
    "". View it in ui.perfetto.dev or chrome://tracing."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    out = pathlib.Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    print(f"torch.profiler trace written to {path}")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def force_completion(tree) -> None:
    """Wait until the work that produced every tensor in ``tree`` (a tensor,
    or dicts, lists and tuples of them) has finished on its device."""
    for dev in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def step_timer(result: dict, key: str, n_items: int = 1):
    """Time a block up to the completion of its output; writes items/s
    into ``result[key]`` and seconds into ``result[key + "_seconds"]``.
    The block receives a one-slot list to put its output in::

        with step_timer(out, "steps_per_sec", n) as sync:
            sync.append(rollout(lf))
    """
    sync: list = []
    t0 = time.perf_counter()
    yield sync
    if sync:
        force_completion(sync[-1])
    dt = time.perf_counter() - t0
    result[key] = n_items / dt if dt > 0 else float("inf")
    result[f"{key}_seconds"] = dt


class StageClock:
    """Seconds per named stage, exclusive of the stages nested in it, each
    stage closed by a device synchronize::

        clock = StageClock(device)
        with clock("metrics"):
            ...
            with clock("rollout"):   # not counted in "metrics"
                ...
        clock.seconds  # {"metrics": ..., "rollout": ...}
    """

    def __init__(self, device: torch.device | str = "cpu", seconds: dict | None = None):
        self.device = torch.device(device)
        self.seconds = {} if seconds is None else seconds
        self._nested: list[float] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        self._nested.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            own = dt - self._nested.pop()
            self.seconds[name] = self.seconds.get(name, 0.0) + own
            if self._nested:
                self._nested[-1] += dt
