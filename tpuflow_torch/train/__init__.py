"""NLL training: the windowed-BPTT step, the optimizer, checkpoints, the
trainer, and the (data, ensemble) mesh over ``torch.distributed``."""

from tpuflow_torch.train.checkpoint import Checkpointer
from tpuflow_torch.train.mesh import (
    Mesh,
    all_reduce_mean_,
    data_sharding,
    ensemble_sharding,
    initialize_multihost,
    make_mesh,
    shard_batch,
)
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
    "Mesh",
    "Trainer",
    "all_reduce_mean_",
    "clip_by_global_norm_",
    "data_sharding",
    "ensemble_sharding",
    "initialize_multihost",
    "make_mesh",
    "make_optimizer",
    "shard_batch",
    "train_step",
    "trajectory_train_step",
    "window_bpd_fn",
]
