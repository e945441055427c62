"""Train a TM-Glow model on a case.

Usage: python -m tpuflow_torch.cli.train <case> [key=value ...] [--device cuda|cpu]

Metrics go to ``{train.checkpoint_dir}/{case}/train_log.csv`` and stdout,
and, with ``train.tensorboard_dir``, to TensorBoard scalar summaries
there; checkpoints to the same directory, from which a rerun resumes.
"""

from __future__ import annotations

import pathlib

from tpuflow_torch.cli import parse_args
from tpuflow_torch.train.trainer import Trainer
from tpuflow_torch.utils.logging import MetricsLogger


def main(argv: list[str] | None = None) -> dict:
    cfg, device = parse_args(argv, prog="python -m tpuflow_torch.cli.train")
    logger = MetricsLogger(pathlib.Path(cfg.train.checkpoint_dir) / cfg.name / "train_log.csv",
                           tensorboard_dir=cfg.train.tensorboard_dir or None)
    trainer = Trainer(cfg, logger=logger, device=device)
    try:
        trainer.init_or_resume()
        final = trainer.run()
    finally:
        logger.close()
        trainer.close()
    print(f"done: epoch={final['epoch']} mean_bpd={final['mean_bpd']:.4f} "
          f"windows/s={final['windows_per_sec']:.2f}")
    return final


if __name__ == "__main__":
    main()
