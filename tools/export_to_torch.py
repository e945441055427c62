"""Export a JAX Orbax checkpoint of tpuflow to a checkpoint of the PyTorch
port (tpuflow_torch).

    python tools/export_to_torch.py <case> <orbax_checkpoint_dir> <out_dir> [--step N] [key=value ...]

``<orbax_checkpoint_dir>`` is a ``train.checkpoint_dir`` of the JAX
package (it holds ``<case>/<step>/``). The checkpoint is restored with
the JAX package's ``load_eval_bundle``, its variables are mapped onto a
CPU ``TMGlow`` of the port by ``tpuflow_torch.convert.from_flax``, and
the port's ``Checkpointer`` writes ``<out_dir>/<case>/ckpt_{step:08d}.pt``
with the same step. Trailing ``key=value`` overrides (``model.*``, for a
checkpoint trained at other widths than the preset's) apply to both
packages' configs. The file holds:

  * "model": the port's state dict (float32);
  * "norm": the checkpoint's normalization constants, as tensors;
  * "meta": the JAX meta as it is (``config``, ``epoch``,
    ``global_step``, ``learned_tau`` where fine-tuned, ...) plus
    ``"source"``: the Orbax directory it came from.

It holds no optimizer state: the port's trainer refuses to resume from
it. Serve it with ``python -m tpuflow_torch.cli.rollout <case>
train.checkpoint_dir=<out_dir>``.

This is the one module outside the tests that imports both packages. It
runs where JAX is; nothing in ``tpuflow_torch`` imports it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def export(case: str, orbax_dir: str | pathlib.Path, out_dir: str | pathlib.Path,
           step: int | None = None, overrides: dict | None = None) -> pathlib.Path:
    """Export step ``step`` (default: the latest) of the JAX checkpoint of
    ``case`` under ``orbax_dir`` to ``out_dir``, both configs built with
    ``overrides``; returns the file written."""
    import jax
    import torch

    from tpuflow.configs.config import load_case as j_load_case
    from tpuflow.eval.loading import load_eval_bundle as j_load_eval_bundle
    from tpuflow.train.checkpoint import Checkpointer as JCheckpointer
    from tpuflow_torch.configs import load_case
    from tpuflow_torch.convert import from_flax
    from tpuflow_torch.models import TMGlow
    from tpuflow_torch.train import Checkpointer

    orbax_dir = pathlib.Path(orbax_dir)
    if step is None:
        step = JCheckpointer(orbax_dir / case).latest_step()
        if step is None:
            raise FileNotFoundError(f"no JAX checkpoint under {orbax_dir / case}")
    overrides = dict(overrides or {})
    jcfg = j_load_case(case, {**overrides, "train.checkpoint_dir": str(orbax_dir)})
    _, variables, norm, meta = j_load_eval_bundle(jcfg, step)
    cfg = load_case(case, overrides)
    model = TMGlow(cfg.model, device="cpu")
    model.load_state_dict(from_flax(jax.device_get(variables), model))
    return Checkpointer(pathlib.Path(out_dir) / case).save(step, {
        "model": model.state_dict(),
        "norm": {k: torch.from_numpy(v.astype("float32")) for k, v in norm.to_dict().items()},
        "meta": {**meta, "source": str(orbax_dir)},
    })


def main(argv: list[str] | None = None) -> pathlib.Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", help="case preset name (the same in both packages)")
    ap.add_argument("orbax_dir", help="the JAX train.checkpoint_dir (holds <case>/<step>/)")
    ap.add_argument("out_dir", help="the port's train.checkpoint_dir to write")
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    ap.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = ap.parse_intermixed_args(argv)
    import jax

    from tpuflow_torch.configs import parse_cli_overrides

    jax.config.update("jax_platforms", "cpu")
    out = export(args.case, args.orbax_dir, args.out_dir, args.step,
                 parse_cli_overrides(args.overrides))
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
