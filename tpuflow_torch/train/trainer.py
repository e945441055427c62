"""Trainer: epoch loop over trajectory batches, truncated-BPTT windows,
validation and checkpoints, on one device.

Counterpart of ``tpuflow/train/trainer.py`` on a single device (no mesh).
A fresh run builds the model from ``train.seed`` and initialises its
ActNorms from the first real trajectory batch (``TMGlow.data_init``, the
counterpart of ``model.init`` on that batch); a run whose checkpoint
directory holds a step resumes from it. Each trajectory batch runs every
window of :func:`~tpuflow_torch.train.step.trajectory_train_step`. When
the training split fits ``data.device_resident_max_gb``, it is moved to
the device once and batches are gathered there by index, as the JAX
package's default path does; otherwise each batch is uploaded. Every
``train.log_every``-th window logs its bpd and its gradient norm before
the clip (a logged row waits for the device; other windows do not).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.data.dataset import TrajectoryDataset, find_archive, load_dataset
from tpuflow_torch.device import resolve_device
from tpuflow_torch.eval.rollout import make_nll_eval
from tpuflow_torch.models.tmglow import TMGlow, init_lstm_state
from tpuflow_torch.train.checkpoint import Checkpointer
from tpuflow_torch.train.step import make_optimizer, trajectory_train_step
from tpuflow_torch.utils.logging import MetricsLogger


class Trainer:
    """NLL training for one case config on ``device`` (default ``"cuda"``)."""

    def __init__(
        self,
        cfg: CaseConfig,
        dataset: TrajectoryDataset | None = None,
        logger: MetricsLogger | None = None,
        device: str | torch.device = "cuda",
    ):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = dataset or load_dataset(cfg.data, cfg.model, "train")
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
        self.model = TMGlow(cfg.model, device=self.device, seed=cfg.train.seed)
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), cfg.train.lr, cfg.train.lr_decay, cfg.train.weight_decay
        )
        self.logger = logger or MetricsLogger()
        self.ckpt = Checkpointer(f"{cfg.train.checkpoint_dir}/{cfg.name}")
        nbytes = self.dataset.lf.nbytes + self.dataset.hf.nbytes
        self._resident = (
            cfg.data.device_resident and nbytes <= cfg.data.device_resident_max_gb * 2**30
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
            print(f"resumed from epoch {self.epoch} (step {self.global_step})")
        else:
            self._fresh_init()
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
        return self._epoch_loop(epochs)

    def _batches(self, seed: int):
        b = self.cfg.data.batch_size
        if not self._resident:
            for lf, hf in self.dataset.traj_batches(seed, b):
                yield torch.from_numpy(lf).to(self.device), torch.from_numpy(hf).to(self.device)
            return
        if self._split is None:
            self._split = (torch.from_numpy(self.dataset.lf).to(self.device),
                           torch.from_numpy(self.dataset.hf).to(self.device))
        lf_all, hf_all = self._split
        for idx in self.dataset.batch_indices(seed, b):
            idx = torch.from_numpy(idx).to(self.device)
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
                    cfg.data.window, lf, hf,
                )
                per_batch.append(m)
                for i in range(m["bpd"].shape[0]):
                    self.global_step += 1
                    every = cfg.train.log_every
                    if every and self.global_step % every == 0:
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
            if self.epoch % cfg.train.checkpoint_every == 0 or self.epoch == epochs:
                self.save()
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
        val_bpd = float(nll(lf, hf).mean())
        logger.log(self.global_step, epoch=self.epoch, val_bpd=val_bpd)
        return val_bpd

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
