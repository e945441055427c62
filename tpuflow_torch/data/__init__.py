"""Data: the procedural fixture, archives (.h5/.hdf5, .npz, .tpf),
normalization, trajectory batches and BPTT windows, the streamed .tpf
store and downloads."""

from tpuflow_torch.data.dataset import (
    NormStats,
    TrajectoryDataset,
    load_archive,
    load_dataset,
    save_archive,
)
from tpuflow_torch.data.synthetic import generate_case
from tpuflow_torch.data.tpf import (
    PrefetchingWindowLoader,
    StreamingTrajectoryDataset,
    TPFStore,
    compute_norm_streaming,
    save_tpf,
)

__all__ = [
    "NormStats",
    "PrefetchingWindowLoader",
    "StreamingTrajectoryDataset",
    "TPFStore",
    "TrajectoryDataset",
    "compute_norm_streaming",
    "generate_case",
    "load_archive",
    "load_dataset",
    "save_archive",
    "save_tpf",
]
