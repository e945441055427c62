"""NLL training: the windowed-BPTT step, the optimizer, checkpoints and
the trainer."""

from tpuflow_torch.train.checkpoint import Checkpointer
from tpuflow_torch.train.step import (
    clip_by_global_norm_,
    make_optimizer,
    train_step,
    trajectory_train_step,
    window_bpd_fn,
)
from tpuflow_torch.train.trainer import Trainer

__all__ = [
    "Checkpointer",
    "Trainer",
    "clip_by_global_norm_",
    "make_optimizer",
    "train_step",
    "trajectory_train_step",
    "window_bpd_fn",
]
