"""Trainer: epoch loop over trajectory batches, truncated-BPTT windows,
validation and checkpoints, on one device per process.

Counterpart of ``tpuflow/train/trainer.py``. A fresh run builds the model
from ``train.seed`` and initialises its ActNorms from the first real
trajectory batch (``TMGlow.data_init``, the counterpart of ``model.init``
on that batch); a run whose checkpoint directory holds a step resumes
from it. Each trajectory batch runs every window of
:func:`~tpuflow_torch.train.step.trajectory_train_step`. When an in-RAM
training split fits ``data.device_resident_max_gb``, it is moved to the
device once and batches are gathered there by index, as the JAX
package's default path does; otherwise each batch is uploaded (a
streamed ``.tpf`` split never goes resident). Every
``train.log_every``-th window logs its bpd and its gradient norm before
the clip (a logged row waits for the device; other windows do not).

Data parallelism (``train/mesh.py``): under ``torchrun`` with a process
group of ``train.mesh_data`` x ``train.mesh_ensemble`` ranks
(``mesh_data=-1``: world // mesh_ensemble), every rank walks the same
seeded batch order and trains on its rows of each batch; the step
averages gradients and bpd over the ranks. The JAX trainer shrinks an
automatic data axis to a divisor of the batch; a process group cannot
shrink, so a data size that does not divide ``data.batch_size``, or an
explicit mesh that is not the world, raises ``ValueError``. ActNorm's
init runs on the full first batch on every rank, as JAX initialises on
the unsharded batch, and one collective then checks that the ranks hold
the same parameters (after a resume too). Rank 0 alone writes
checkpoints, the metrics log, plots and validation rows; every rank
reads a resume.

The training options of the JAX trainer:

* ``train.remat``: each timestep runs under ``torch.utils.checkpoint``;
* ``train.debug_nans``: the counterpart of ``jax_debug_nans``. A forward
  hook on every module raises ``FloatingPointError`` naming the first
  module whose output is not finite, and autograd's anomaly mode names
  the backward function that made a NaN. Each hook waits on the device,
  so it is off by default;
* ``train.trace_dir``: the epoch loop runs under
  ``utils.profiling.trace_context`` (a ``torch.profiler`` Chrome trace);
* ``train.plot_every``: every N epochs a sample at tau 0.7 of the first
  training batch's first frame, drawn by ``eval.plots.
  plot_prediction_panels`` into ``<checkpoint_dir>/<case>/train_plots``
  (needs matplotlib, checked at construction);
* validation touches the logger's file every 60 s while it runs, the
  supervisor's heartbeat.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import threading
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import NormStats, TrajectoryDataset, find_archive, load_dataset
from tpuflow_torch.data.tpf import StreamingTrajectoryDataset
from tpuflow_torch.device import resolve_device
from tpuflow_torch.eval.rollout import make_nll_eval
from tpuflow_torch.models.tmglow import TMGlow, init_lstm_state
from tpuflow_torch.train import mesh as mesh_lib
from tpuflow_torch.train.checkpoint import Checkpointer
from tpuflow_torch.train.step import make_optimizer, trajectory_train_step
from tpuflow_torch.utils.logging import MetricsLogger
from tpuflow_torch.utils.profiling import _leaves, trace_context

# tau of the periodic training sample (the JAX trainer's).
_PLOT_TAU = 0.7


def _nan_hook(name: str):
    def hook(module, inputs, output):
        for t in _leaves(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"debug_nans: non-finite output of module {name!r} "
                    f"({type(module).__name__})")
    return hook


def install_nan_hooks(model: nn.Module) -> list:
    """A forward hook on every submodule of ``model`` that raises
    ``FloatingPointError`` naming the module whose output holds a NaN or
    inf; returns the hook handles. Innermost modules finish first, so the
    first module named is where the value appeared."""
    return [m.register_forward_hook(_nan_hook(n or type(model).__name__))
            for n, m in model.named_modules()]


def trainer_mesh(cfg: CaseConfig) -> mesh_lib.Mesh:
    """The (data, ensemble) mesh of the process group's ranks (one rank
    without a group) from ``train.mesh_data`` and ``train.mesh_ensemble``;
    raises ``ValueError`` where it is not the whole world or its data size
    does not divide ``data.batch_size``."""
    t, b = cfg.train, cfg.data.batch_size
    world = mesh_lib.world_size()
    if t.mesh_data != -1 and t.mesh_data * t.mesh_ensemble != world:
        raise ValueError(
            f"train.mesh_data={t.mesh_data} x train.mesh_ensemble={t.mesh_ensemble} covers "
            f"{t.mesh_data * t.mesh_ensemble} ranks, but the process group has {world}: a "
            "process group cannot shrink; set mesh_data=-1 or launch that many processes"
        )
    mesh = mesh_lib.make_mesh(t.mesh_data, t.mesh_ensemble, devices=list(range(world)))
    if b % mesh.data:
        raise ValueError(
            f"data.batch_size={b} does not divide over the mesh's data size {mesh.data} "
            f"({world} ranks / mesh_ensemble {t.mesh_ensemble}); a process group cannot "
            "shrink to a divisor, so change the batch size or the number of processes"
        )
    return mesh


class Trainer:
    """NLL training for one case config on ``device`` (default ``"cuda"``);
    with a process group, this rank's share of data-parallel training."""

    def __init__(
        self,
        cfg: CaseConfig,
        dataset: TrajectoryDataset | StreamingTrajectoryDataset | None = None,
        logger: MetricsLogger | None = None,
        device: str | torch.device = "cuda",
    ):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = trainer_mesh(cfg)
        self._rows = mesh_lib.data_sharding(self.mesh, cfg.data.batch_size)
        self._main = mesh_lib.rank() == 0
        self.dataset = dataset or load_dataset(cfg.data, cfg.model, "train")
        if self._main and isinstance(self.dataset, StreamingTrajectoryDataset):
            store = self.dataset.store
            print(f"streaming {store.path} (native loader: {store.native})")
        if cfg.data.window > self.dataset.n_steps:
            raise ValueError(
                f"data.window={cfg.data.window} exceeds the dataset's trajectory "
                f"length {self.dataset.n_steps}: no BPTT window fits, so training "
                "would silently do nothing"
            )
        if cfg.train.eval_every and not cfg.data.synthetic:
            try:
                find_archive(cfg.data.data_dir, cfg.data.case, "test")
            except FileNotFoundError as e:
                raise ValueError(
                    f"train.eval_every={cfg.train.eval_every} needs the test split: {e}"
                ) from e
        if cfg.train.plot_every and importlib.util.find_spec("matplotlib") is None:
            raise ValueError(
                f"train.plot_every={cfg.train.plot_every} draws figures, but matplotlib is "
                "not installed; set train.plot_every=0"
            )
        self.model = TMGlow(cfg.model, device=self.device, seed=cfg.train.seed)
        self._nan_hooks = install_nan_hooks(self.model) if cfg.train.debug_nans else []
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), cfg.train.lr, cfg.train.lr_decay, cfg.train.weight_decay
        )
        self.logger = logger or MetricsLogger()
        self.ckpt = Checkpointer(f"{cfg.train.checkpoint_dir}/{cfg.name}")
        self._resident = (
            cfg.data.device_resident
            and isinstance(self.dataset, TrajectoryDataset)
            and self.dataset.lf.nbytes + self.dataset.hf.nbytes
            <= cfg.data.device_resident_max_gb * 2**30
        )
        self._split = None  # (lf, hf) on the device, moved once
        self._val = None
        self._ready = False
        self.epoch = 0
        self.global_step = 0

    # ------------------------------------------------------------- init

    def init_or_resume(self) -> None:
        restored = self.ckpt.restore(map_location=self.device)
        if restored is not None:
            if "optimizer" not in restored:
                raise ValueError(
                    f"checkpoint step {self.ckpt.latest_step()} under {self.ckpt.directory} "
                    "holds no optimizer state (an export of weights for serving, "
                    f"source {restored['meta'].get('source', 'unknown')!r}): training cannot "
                    "resume from it; point train.checkpoint_dir elsewhere"
                )
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            self.scheduler.load_state_dict(restored["scheduler"])
            self.epoch = int(restored["meta"]["epoch"])
            self.global_step = int(restored["meta"]["global_step"])
            if isinstance(self.dataset, StreamingTrajectoryDataset):
                # The checkpoint's constants are authoritative, and spare the
                # store its full normalization sweep.
                self.dataset.norm = NormStats.from_dict(
                    {k: v.cpu() for k, v in restored["norm"].items()})
            print(f"resumed from epoch {self.epoch} (step {self.global_step})")
        else:
            self._fresh_init()
        mesh_lib.assert_replicated(list(self.model.state_dict().values()))
        self._ready = True

    def _fresh_init(self) -> None:
        cfg = self.cfg
        b = cfg.data.batch_size
        lf_b, hf_b = next(self.dataset.traj_batches(cfg.data.seed, b))
        self.model.data_init(
            torch.from_numpy(hf_b[:, 0]).to(self.device),
            torch.from_numpy(lf_b[:, 0]).to(self.device),
            init_lstm_state(cfg.model, b, self.device),
        )
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"initialized {n_params:,} parameters")

    # ------------------------------------------------------------ train

    def run(self, epochs: int | None = None) -> dict[str, Any]:
        """Train up to ``epochs`` completed epochs (default: the config's);
        return the last epoch's metrics."""
        if not self._ready:
            self.init_or_resume()
        epochs = self.cfg.train.epochs if epochs is None else epochs
        if self.epoch >= epochs:
            print(f"already trained to epoch {self.epoch} (>= {epochs}); nothing to do")
            return {"epoch": self.epoch, "mean_bpd": float("nan"), "windows_per_sec": 0.0}
        anomaly = (torch.autograd.detect_anomaly() if self.cfg.train.debug_nans
                   else contextlib.nullcontext())
        with trace_context(self.cfg.train.trace_dir or None), anomaly:
            return self._epoch_loop(epochs)

    def _batches(self, seed: int):
        """This rank's rows of each trajectory batch, on the device."""
        b = self.cfg.data.batch_size
        if not self._resident:
            for lf, hf in self.dataset.traj_batches(seed, b, rows=self._rows):
                yield torch.from_numpy(lf).to(self.device), torch.from_numpy(hf).to(self.device)
            return
        if self._split is None:
            self._split = (torch.from_numpy(self.dataset.lf).to(self.device),
                           torch.from_numpy(self.dataset.hf).to(self.device))
        lf_all, hf_all = self._split
        for idx in self.dataset.batch_indices(seed, b):
            idx = torch.from_numpy(idx[self._rows]).to(self.device)
            yield lf_all[idx], hf_all[idx]

    def _epoch_loop(self, epochs: int) -> dict[str, Any]:
        cfg = self.cfg
        last: dict[str, Any] = {}
        while self.epoch < epochs:
            t0 = time.perf_counter()
            per_batch = []
            for lf, hf in self._batches(cfg.data.seed + self.epoch):
                m = trajectory_train_step(
                    self.model, self.optimizer, self.scheduler, cfg.train.grad_clip,
                    cfg.data.window, lf, hf, cfg.train.remat,
                )
                per_batch.append(m)
                for i in range(m["bpd"].shape[0]):
                    self.global_step += 1
                    every = cfg.train.log_every
                    if self._main and every and self.global_step % every == 0:
                        self.logger.log(self.global_step, epoch=self.epoch,
                                        bpd=m["bpd"][i], grad_norm=m["grad_norm"][i])
            bpd = torch.cat([m["bpd"] for m in per_batch]).cpu()
            dt = time.perf_counter() - t0
            self.epoch += 1
            last = {
                "epoch": self.epoch,
                "mean_bpd": float(bpd.mean()),
                "windows_per_sec": len(bpd) / dt,
            }
            if not self._main:
                continue
            if self.epoch % cfg.train.checkpoint_every == 0 or self.epoch == epochs:
                self.save()
            if cfg.train.plot_every and self.epoch % cfg.train.plot_every == 0:
                self._plot_sample()
            if cfg.train.eval_every and self.epoch % cfg.train.eval_every == 0:
                last["val_bpd"] = self._validate()
        return last

    def _validate(self) -> float:
        """Held-out NLL (bits/dim) over the whole test split, normalized
        with the train constants, logged to val_log.csv."""
        if self._val is None:
            val = load_dataset(self.cfg.data, self.cfg.model, "test", norm=self.dataset.norm)
            self._val = (
                torch.from_numpy(val.lf).to(self.device),
                torch.from_numpy(val.hf).to(self.device),
                make_nll_eval(self.model),
                MetricsLogger(self.ckpt.directory / "val_log.csv", quiet=True),
            )
        lf, hf, nll, logger = self._val
        # Keep the supervisor's heartbeat (the train log's mtime) alive for
        # the whole validation: it is progress, not a stall.
        stop = threading.Event()

        def tick():
            while not stop.wait(60.0):
                self.logger.touch()

        ticker = threading.Thread(target=tick, daemon=True)
        self.logger.touch()
        ticker.start()
        try:
            val_bpd = float(nll(lf, hf).mean())
        finally:
            stop.set()
            ticker.join()
        logger.log(self.global_step, epoch=self.epoch, val_bpd=val_bpd)
        return val_bpd

    def _plot_sample(self) -> None:
        """The periodic sample figure: one draw at tau 0.7 on the first
        training batch's first LF frame (from a zero state, the generator
        seeded by the epoch), plotted against its HF target."""
        from tpuflow_torch.eval.plots import plot_prediction_panels

        cfg = self.cfg
        b = cfg.data.batch_size
        lf_b, hf_b = next(self.dataset.traj_batches(cfg.data.seed, b))
        gen = torch.Generator(self.device).manual_seed(self.epoch)
        with torch.no_grad():
            x, _ = self.model.sample_step(
                torch.from_numpy(lf_b[:, 0]).to(self.device),
                init_lstm_state(cfg.model, b, self.device), _PLOT_TAU, generator=gen)
        plot_prediction_panels(
            self.ckpt.directory / "train_plots", lf_b[0, 0], hf_b[0, 0],
            x[0].float().cpu().numpy(), np.zeros_like(hf_b[0, 0]), t=self.epoch,
        )

    def save(self) -> None:
        self.ckpt.save(self.epoch, {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "norm": {k: torch.from_numpy(v) for k, v in self.dataset.norm.to_dict().items()},
            "meta": {
                "epoch": self.epoch,
                "global_step": self.global_step,
                "config": dataclasses.asdict(self.cfg),
            },
        })

    def close(self) -> None:
        if self._val is not None:
            self._val[3].close()
