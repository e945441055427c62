"""Data and ensemble parallelism: the (data, ensemble) mesh over
``torch.distributed`` ranks or devices.

Counterpart of ``tpuflow/train/mesh.py``. The JAX package names a
``(data, ensemble)`` device mesh and lets XLA insert the collectives; here
the same two strategies are explicit:

* training (data parallelism): one process per device, launched by
  ``torchrun``. Every rank walks the same seeded batch order and takes
  the contiguous rows of each batch that :func:`data_sharding` gives its
  data index; after the backward, :func:`all_reduce_mean_` averages the
  gradients over the ranks in one collective, which is the psum-mean XLA
  inserts for the data axis. Ranks that share a data index (they differ
  in their ensemble index) train on the same rows, as the JAX mesh
  replicates a batch over its ``ensemble`` axis, so the mean over all
  ranks equals the mean over the data shards;
* sampling (ensemble parallelism): one process drives every device of
  the mesh; :func:`ensemble_sharding` splits the members into one
  contiguous chunk per device (``eval/rollout.py``).

The JAX ``replicated_sharding`` has no counterpart: every rank builds and
updates the same parameters; :func:`assert_replicated` checks that they
agree.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist

@dataclass(frozen=True)
class Mesh:
    """A (data, ensemble) grid over ``devices``, row-major: entry
    ``i * ensemble + j`` sits at data index i, ensemble index j. An entry
    is a process-group rank (training) or a ``torch.device`` (one process
    driving several devices)."""

    data: int
    ensemble: int
    devices: tuple

    @property
    def size(self) -> int:
        return self.data * self.ensemble

    def data_index(self, rank: int) -> int:
        return rank // self.ensemble


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _default_devices(devices) -> list:
    if devices == "cpu":
        return [torch.device("cpu")]
    if devices is not None:
        return list(devices)
    if dist.is_available() and dist.is_initialized():
        return list(range(world_size()))
    from tpuflow_torch.device import resolve_device

    resolve_device("cuda")  # raises where there is no GPU
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = -1, ensemble: int = 1, devices: Sequence | str | None = None) -> Mesh:
    """Build the (data, ensemble) mesh, with the arithmetic and errors of
    the JAX package's ``make_mesh``.

    Args:
      data: data-parallel axis size; -1 = all remaining devices.
      ensemble: ensemble-parallel axis size.
      devices: the mesh's entries. Default: the process group's ranks when
        one is initialized, else every visible CUDA device (raises without
        a GPU); ``"cpu"`` for ``[cpu]``.
    """
    devices = _default_devices(devices)
    n = len(devices)
    if data == -1:
        if n % ensemble:
            raise ValueError(f"{n} devices not divisible by ensemble={ensemble}")
        data = n // ensemble
    if data < 1 or ensemble < 1:
        raise ValueError(
            f"mesh axes must be >=1, got data={data} ensemble={ensemble} "
            f"(devices available: {n})"
        )
    if data * ensemble > n:
        raise ValueError(f"mesh {data}x{ensemble} needs {data * ensemble} devices, have {n}")
    return Mesh(data, ensemble, tuple(devices[: data * ensemble]))


def data_sharding(mesh: Mesh, batch_size: int, rank_: int | None = None) -> slice:
    """The rows of a ``batch_size`` batch that ``rank_`` (default: this
    process's rank) takes: block ``rank_ // ensemble`` of ``mesh.data``
    equal contiguous blocks."""
    if batch_size % mesh.data:
        raise ValueError(
            f"batch of {batch_size} rows does not split over a data axis of {mesh.data}"
        )
    per = batch_size // mesh.data
    i = mesh.data_index(rank() if rank_ is None else rank_)
    return slice(i * per, (i + 1) * per)


def ensemble_sharding(mesh: Mesh, n_samples: int) -> list[slice]:
    """The members of each mesh entry, in order: ``n_samples`` split into
    ``mesh.size`` equal contiguous chunks over both axes, as the JAX
    package shards the member axis over ``(data, ensemble)``."""
    if n_samples % mesh.size:
        raise ValueError(
            f"n_samples={n_samples} does not split over the mesh's {mesh.size} devices"
        )
    per = n_samples // mesh.size
    return [slice(i * per, (i + 1) * per) for i in range(mesh.size)]


def shard_batch(x, mesh: Mesh, rank_: int | None = None):
    """This rank's rows of ``x`` (leading axis the batch)."""
    return x[data_sharding(mesh, x.shape[0], rank_)]


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` (one device, one dtype) over the process group's
    ranks, in place, with one collective: they are flattened into one
    buffer, summed across ranks and divided by the world size. A no-op
    without a process group of more than one rank."""
    world = world_size()
    if world == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(f.view_as(t))


@torch.no_grad()
def assert_replicated(tensors: Sequence[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` on every rank unless every rank holds the same
    ``tensors``: one all-reduce (max) of per-tensor float64 checksums
    beside their negatives, so the maximum and the minimum over the ranks
    come back together and agree only where every rank's checksum does."""
    if world_size() == 1:
        return
    sums = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                        for t in tensors]).reshape(-1)
    both = torch.cat([sums, -sums])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    hi, neg_lo = both.chunk(2)
    bad = (hi != -neg_lo).reshape(-1, 2).any(dim=1).nonzero().flatten().tolist()
    if bad:
        raise RuntimeError(
            f"parameters differ across ranks ({len(bad)} of {len(tensors)} tensors, "
            f"first at index {bad[0]})"
        )


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Join the process group: ``nccl`` for CUDA, ``gloo`` for the CPU.
    With no arguments it takes torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); else ``coordinator`` is
    ``host:port`` and ``num_processes`` / ``process_id`` the world size
    and rank. The counterpart of ``jax.distributed.initialize``."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost: a coordinator needs num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def local_rank() -> int:
    """torchrun's ``LOCAL_RANK`` (0 without it): this process's GPU index."""
    return int(os.environ.get("LOCAL_RANK", "0"))
