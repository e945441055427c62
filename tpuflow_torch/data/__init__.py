"""Data: the procedural fixture, normalization, trajectory batches and
BPTT windows."""

from tpuflow_torch.data.dataset import NormStats, TrajectoryDataset, load_dataset
from tpuflow_torch.data.synthetic import generate_case

__all__ = ["NormStats", "TrajectoryDataset", "generate_case", "load_dataset"]
