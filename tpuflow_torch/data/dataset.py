"""Trajectory dataset: normalization, trajectory batching, BPTT windows.

Counterpart of ``tpuflow/data/dataset.py``. The training loop iterates
shuffled trajectory batches and, within a batch, consecutive time
windows, so that the ConvLSTM state carries across windows (truncated
BPTT). Normalization is
per-channel mean and standard deviation (ddof 0, as ``np.std``) over
the training split, applied identically to every split.

An archive is ``{data_dir}/{case}_{split}`` with suffix ``.h5``, ``.hdf5``,
``.npz`` or ``.tpf`` (looked for in that order), holding arrays ``lf``
(N, T, h, w, C) and ``hf`` (N, T, H, W, C); ``h5py`` is imported only
when an HDF5 file is read or written. ``data.loader=stream`` serves the
training split from ``{case}_train.tpf`` through the native loader
(``data/tpf.py``) instead of RAM. Arrays stay NumPy here; the trainer
moves them to the device.
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

    def traj_batches(self, seed: int, batch_size: int, drop_remainder: bool = True,
                     rows: slice = slice(None)):
        """Yield shuffled (lf, hf) trajectory batches (B, T, ...); ``rows``
        selects rows of each batch (a data-parallel rank's share)."""
        for idx in self.batch_indices(seed, batch_size, drop_remainder):
            yield self.lf[idx[rows]], self.hf[idx[rows]]

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


_SUFFIXES = (".h5", ".hdf5", ".npz", ".tpf")


def _h5py(path: pathlib.Path):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path}: reading or writing HDF5 archives needs h5py") from e
    return h5py


def load_archive(path: str | pathlib.Path) -> tuple[np.ndarray, np.ndarray]:
    """Read an (lf, hf) trajectory archive (.h5/.hdf5, .npz or .tpf)."""
    path = pathlib.Path(path)
    if path.suffix in (".h5", ".hdf5"):
        with _h5py(path).File(path, "r") as f:
            return np.asarray(f["lf"]), np.asarray(f["hf"])
    if path.suffix == ".npz":
        with np.load(path) as f:
            return f["lf"], f["hf"]
    if path.suffix == ".tpf":
        from tpuflow_torch.data.tpf import TPFStore

        with TPFStore(path) as store:
            everything = np.arange(store.n_traj)
            return (store.read_batch("lf", everything, 0, store.n_steps),
                    store.read_batch("hf", everything, 0, store.n_steps))
    raise ValueError(f"unsupported archive {path} (want .h5/.hdf5/.npz/.tpf)")


def save_archive(path: str | pathlib.Path, lf: np.ndarray, hf: np.ndarray) -> None:
    """Write an (lf, hf) trajectory archive; the suffix picks the format
    (.h5/.hdf5 gzip-compressed, .npz compressed, .tpf)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix in (".h5", ".hdf5"):
        with _h5py(path).File(path, "w") as f:
            f.create_dataset("lf", data=lf, compression="gzip")
            f.create_dataset("hf", data=hf, compression="gzip")
        return
    if path.suffix == ".npz":
        np.savez_compressed(path, lf=lf, hf=hf)
        return
    if path.suffix == ".tpf":
        from tpuflow_torch.data.tpf import save_tpf

        save_tpf(path, lf, hf)
        return
    raise ValueError(f"unsupported archive {path} (want .h5/.hdf5/.npz/.tpf)")


def find_archive(root: pathlib.Path, case: str, split: str) -> pathlib.Path:
    """``{root}/{case}_{split}`` with the first suffix found of .h5, .hdf5,
    .npz, .tpf."""
    for suffix in _SUFFIXES:
        p = pathlib.Path(root) / f"{case}_{split}{suffix}"
        if p.exists():
            return p
    raise FileNotFoundError(
        f"no archive {root}/{case}_{split}.(h5|hdf5|npz|tpf); "
        "set data.synthetic=true for the procedural fixture"
    )


def load_dataset(
    data_cfg: DataConfig,
    model_cfg: ModelConfig,
    split: str = "train",
    norm: NormStats | None = None,
) -> TrajectoryDataset:
    """The dataset of ``split``, as the JAX package's ``load_dataset``.

    Synthetic mode generates from the config seed (the test split from
    ``seed + 10000``); archive mode reads ``{data_dir}/{case}_{split}``
    (:func:`find_archive`). With ``data.loader=stream`` the train split is
    a :class:`~tpuflow_torch.data.tpf.StreamingTrajectoryDataset` over
    ``{case}_train.tpf``. Without ``norm``, every split is normalized with
    the train split's constants.
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
    if data_cfg.loader == "stream" and split == "train":
        from tpuflow_torch.data.tpf import StreamingTrajectoryDataset, TPFStore

        # The store itself, not find_archive: the archive it was converted
        # from may sit in the same directory.
        path = root / f"{data_cfg.case}_train.tpf"
        if not path.exists():
            raise FileNotFoundError(
                f"data.loader=stream needs {path}; convert an archive with "
                "python -m tpuflow_torch.tools.convert_tpf"
            )
        return StreamingTrajectoryDataset(TPFStore(path), norm=norm)
    if data_cfg.loader not in ("ram", "stream"):
        raise ValueError(f"unknown data.loader {data_cfg.loader!r}")
    if norm is None:
        lf_tr, hf_tr = load_archive(find_archive(root, data_cfg.case, "train"))
        norm = NormStats.from_data(lf_tr, hf_tr)
        if split == "train":
            return TrajectoryDataset(lf_tr, hf_tr, norm=norm)
    lf, hf = load_archive(find_archive(root, data_cfg.case, split))
    return TrajectoryDataset(lf, hf, norm=norm)
