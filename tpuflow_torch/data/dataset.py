"""Trajectory dataset: normalization, trajectory batching, BPTT windows.

Counterpart of ``tpuflow/data/dataset.py`` for the synthetic and
``.npz`` routes. The training loop iterates shuffled trajectory batches
and, within a batch, consecutive time windows, so that the ConvLSTM
state carries across windows (truncated BPTT). Normalization is
per-channel mean and standard deviation (ddof 0, as ``np.std``) over
the training split, applied identically to every split.

An archive is ``{data_dir}/{case}_{split}.npz`` with arrays ``lf``
(N, T, h, w, C) and ``hf`` (N, T, H, W, C). Arrays stay NumPy here; the
trainer moves them to the device.
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass

import numpy as np
import torch

from tpuflow_torch.configs.config import DataConfig, ModelConfig
from tpuflow_torch.data.synthetic import generate_case


def _like(c: np.ndarray, x):
    """A per-channel constant in ``x``'s kind: as it is for NumPy, a tensor
    on x's device for a tensor."""
    return torch.as_tensor(c, dtype=x.dtype, device=x.device) if isinstance(x, torch.Tensor) else c


@dataclass(frozen=True)
class NormStats:
    """Per-channel normalization constants (float32 arrays, shape (C,))."""

    lf_mean: np.ndarray
    lf_std: np.ndarray
    hf_mean: np.ndarray
    hf_std: np.ndarray

    @staticmethod
    def from_data(lf: np.ndarray, hf: np.ndarray) -> "NormStats":
        axes = tuple(range(lf.ndim - 1))
        return NormStats(
            lf_mean=lf.mean(axis=axes),
            lf_std=lf.std(axis=axes) + 1e-8,
            hf_mean=hf.mean(axis=axes),
            hf_std=hf.std(axis=axes) + 1e-8,
        )

    def to_dict(self) -> dict:
        return {k: np.asarray(v) for k, v in dataclasses.asdict(self).items()}

    @staticmethod
    def from_dict(d: dict) -> "NormStats":
        """From :meth:`to_dict`'s keys; values may be arrays or CPU tensors."""
        return NormStats(**{k: np.asarray(v, np.float32) for k, v in d.items()})


class TrajectoryDataset:
    """Aligned (LF, HF) trajectories, held normalized, with train-time
    batching and windowing; ``denorm_*`` map model outputs back to
    physical units."""

    def __init__(self, lf: np.ndarray, hf: np.ndarray, norm: NormStats | None = None):
        if lf.ndim != 5 or hf.ndim != 5 or lf.shape[:2] != hf.shape[:2]:
            raise ValueError(
                f"lf {lf.shape} and hf {hf.shape} must be (N, T, H, W, C) with equal N, T"
            )
        self.norm = norm or NormStats.from_data(lf, hf)
        self.lf = ((lf - self.norm.lf_mean) / self.norm.lf_std).astype(np.float32)
        self.hf = ((hf - self.norm.hf_mean) / self.norm.hf_std).astype(np.float32)

    @property
    def n_traj(self) -> int:
        return self.lf.shape[0]

    @property
    def n_steps(self) -> int:
        return self.lf.shape[1]

    def denorm_hf(self, x):
        """Normalized HF field -> physical units (affine); NumPy arrays or
        tensors (computed on their device)."""
        return x * _like(self.norm.hf_std, x) + _like(self.norm.hf_mean, x)

    def denorm_hf_var(self, var):
        """Normalized HF variance -> physical units: a variance scales by
        sigma^2 and takes no mean shift (denorm_hf on a variance would add
        the mean flow to the TKE)."""
        return var * _like(self.norm.hf_std**2, var)

    def denorm_lf(self, x):
        """Normalized LF field -> physical units (affine)."""
        return x * _like(self.norm.lf_std, x) + _like(self.norm.lf_mean, x)

    def batch_indices(self, seed: int, batch_size: int, drop_remainder: bool = True):
        """Yield shuffled trajectory-index batches: the one source of an
        epoch's order (the host-upload and device-resident paths share it)."""
        if drop_remainder and self.n_traj < batch_size:
            raise ValueError(
                f"batch_size={batch_size} exceeds the dataset's "
                f"{self.n_traj} trajectories: zero batches per epoch"
            )
        order = np.random.default_rng(seed).permutation(self.n_traj)
        for i in range(0, len(order) - (batch_size - 1 if drop_remainder else 0), batch_size):
            yield order[i : i + batch_size]

    def traj_batches(self, seed: int, batch_size: int, drop_remainder: bool = True):
        """Yield shuffled (lf, hf) trajectory batches (B, T, ...)."""
        for idx in self.batch_indices(seed, batch_size, drop_remainder):
            yield self.lf[idx], self.hf[idx]

    @staticmethod
    def windows(lf_batch, hf_batch, window: int):
        """Consecutive (lf_win, hf_win) windows of ``window`` steps from a
        (B, T, ...) batch (NumPy or torch); the trailing partial window is
        dropped, and a window longer than T raises."""
        t = lf_batch.shape[1]
        if window > t:
            raise ValueError(
                f"data.window={window} exceeds the trajectory length "
                f"{t}: no BPTT window fits; shrink data.window or "
                "lengthen data.train_steps"
            )
        for w0 in range(0, t - window + 1, window):
            yield lf_batch[:, w0 : w0 + window], hf_batch[:, w0 : w0 + window]


def load_archive(path: str | pathlib.Path) -> tuple[np.ndarray, np.ndarray]:
    """Read an (lf, hf) trajectory archive (``.npz``)."""
    path = pathlib.Path(path)
    if path.suffix != ".npz":
        raise ValueError(
            f"unsupported archive {path}: the port reads .npz (.h5 and .tpf are "
            "not ported yet)"
        )
    with np.load(path) as f:
        return f["lf"], f["hf"]


def find_archive(root: pathlib.Path, case: str, split: str) -> pathlib.Path:
    p = pathlib.Path(root) / f"{case}_{split}.npz"
    if not p.exists():
        raise FileNotFoundError(
            f"no archive {p}; set data.synthetic=true for the procedural fixture"
        )
    return p


def load_dataset(
    data_cfg: DataConfig,
    model_cfg: ModelConfig,
    split: str = "train",
    norm: NormStats | None = None,
) -> TrajectoryDataset:
    """The dataset of ``split``, as the JAX package's ``load_dataset``.

    Synthetic mode generates from the config seed (the test split from
    ``seed + 10000``); archive mode reads ``{data_dir}/{case}_{split}.npz``.
    Without ``norm``, every split is normalized with the train split's
    constants.
    """
    if data_cfg.synthetic:
        n = data_cfg.n_train_traj if split == "train" else data_cfg.n_test_traj
        seed = data_cfg.seed if split == "train" else data_cfg.seed + 10_000
        lf, hf = generate_case(
            data_cfg.case, n, data_cfg.train_steps,
            model_cfg.hf_shape, model_cfg.lf_shape, seed=seed,
            fixture_version=data_cfg.fixture_version,
        )
        if norm is None and split != "train":
            lf_tr, hf_tr = generate_case(
                data_cfg.case, data_cfg.n_train_traj, data_cfg.train_steps,
                model_cfg.hf_shape, model_cfg.lf_shape, seed=data_cfg.seed,
                fixture_version=data_cfg.fixture_version,
            )
            norm = NormStats.from_data(lf_tr, hf_tr)
        return TrajectoryDataset(lf, hf, norm=norm)

    root = pathlib.Path(data_cfg.data_dir)
    if norm is None:
        lf_tr, hf_tr = load_archive(find_archive(root, data_cfg.case, "train"))
        norm = NormStats.from_data(lf_tr, hf_tr)
        if split == "train":
            return TrajectoryDataset(lf_tr, hf_tr, norm=norm)
    lf, hf = load_archive(find_archive(root, data_cfg.case, split))
    return TrajectoryDataset(lf, hf, norm=norm)
