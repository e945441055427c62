"""Train a TM-Glow model on a case.

Usage: python -m tpuflow_torch.cli.train <case> [key=value ...] [--device cuda|cpu]

Data-parallel on N GPUs of one host:

    torchrun --nproc-per-node N -m tpuflow_torch.cli.train <case> [key=value ...]

Under torchrun (``WORLD_SIZE`` in the environment, of any size) each
process joins the process group (``nccl`` on CUDA, ``gloo`` with
``--device cpu``), trains on ``cuda:LOCAL_RANK`` and leaves the group
on exit; the mesh is ``train.mesh_data`` x
``train.mesh_ensemble`` (``train/mesh.py``). Metrics go to
``{train.checkpoint_dir}/{case}/train_log.csv`` and stdout, and, with
``train.tensorboard_dir``, to TensorBoard scalar summaries there;
checkpoints to the same directory, from which a rerun resumes. Rank 0
alone writes them.
"""

from __future__ import annotations

import os
import pathlib

import torch
import torch.distributed as dist

from tpuflow_torch.cli import as_console_script, parse_args
from tpuflow_torch.train import mesh
from tpuflow_torch.train.trainer import Trainer
from tpuflow_torch.utils.logging import MetricsLogger


def main(argv: list[str] | None = None) -> dict:
    cfg, device = parse_args(argv, prog="python -m tpuflow_torch.cli.train")
    distributed = "WORLD_SIZE" in os.environ
    if distributed:
        if torch.device(device).type == "cuda":
            device = f"cuda:{mesh.local_rank()}"
            torch.cuda.set_device(device)
        mesh.initialize_multihost(device=device)
        print(f"process group: {dist.get_backend()}, rank {mesh.rank()} of {mesh.world_size()}",
              flush=True)
    try:
        main_rank = mesh.rank() == 0
        logger = (MetricsLogger(pathlib.Path(cfg.train.checkpoint_dir) / cfg.name / "train_log.csv",
                                tensorboard_dir=cfg.train.tensorboard_dir or None)
                  if main_rank else MetricsLogger(quiet=True))
        trainer = Trainer(cfg, logger=logger, device=device)
        try:
            trainer.init_or_resume()
            final = trainer.run()
        finally:
            logger.close()
            trainer.close()
    finally:
        if distributed:
            dist.destroy_process_group()
    if main_rank:
        print(f"done: epoch={final['epoch']} mean_bpd={final['mean_bpd']:.4f} "
              f"windows/s={final['windows_per_sec']:.2f}")
    return final


cli = as_console_script(main)

if __name__ == "__main__":
    main()
