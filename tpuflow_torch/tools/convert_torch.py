"""PyTorch state_dict -> a complete checkpoint of the port.

    python -m tpuflow_torch.tools.convert_torch <in.pt> <out_dir> <case> [key=value ...]
        [--device cuda|cpu]

Counterpart of ``tpuflow/tools/convert_torch.py``, with the same input
contract: ``<in.pt>`` is a ``torch.save``d ``state_dict``, or a dict
``{"state_dict": ..., "norm": {...}}``, whose keys follow tpuflow's own
naming ("glow.scale0_step1.coupling.net.conv_in_0.weight", ...) with conv
weights in OIHW. Another layout is one ``key_map`` callable (a regex table
to the port's keys, ``None`` skipping a key) passed to
:func:`convert_state_dict`, not new code.

The output is a COMPLETE checkpoint in the port's trainer format
(``train/checkpoint.py``), ``<out_dir>/ckpt_00000000.pt``, so every
consumer reads it: the rollout CLI, the evaluator and, unlike a file of
``tools/export_to_torch.py``, a resume through ``python -m
tpuflow_torch.cli.train`` (with ``train.checkpoint_dir`` the parent of
``<out_dir>``):

  * "model": the converted tensors, validated against the port model's
    own ``state_dict()``. A torch ``state_dict()`` carries registered
    buffers beside the parameters, and the inv-1x1's fixed factors ``p``
    and ``sign_s`` are buffers: a dump without them is refused, since
    converted ``l`` / ``u`` / ``log_s`` beside fresh random factors would
    compose another W. ActNorm's ``initialized`` flag, which tpuflow's
    naming has no key for, is set (as ``tpuflow_torch.convert.from_flax``
    sets it): converted weights are initialized weights;
  * "optimizer" and "scheduler": fresh (``train.step.make_optimizer``); a
    converted checkpoint starts optimization at step 0;
  * "norm": the blob's ``norm`` dict (lf/hf mean/std) where it has one,
    else the configured dataset's training constants, as training
    computes them;
  * "meta": ``epoch`` 0, ``global_step`` 0, ``config`` and ``source`` (the
    input path), the trainer's own keys.

The input is read with ``torch.load(weights_only=False)`` (a ``norm`` may
hold numpy arrays, as the reference's input contract allows): convert
only files you trust. Conversion is host work; ``--device`` (default
``cuda``, raising without a GPU) holds the model the dump is validated
against.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

PROG = "python -m tpuflow_torch.tools.convert_torch"
NORM_KEYS = ("lf_mean", "lf_std", "hf_mean", "hf_std")


def torch_tensor_to_port(name: str, tensor) -> torch.Tensor:
    """The layout rule from a dump's tensor to the port's: the identity.
    The port's convs are OIHW, as a torch dump's, and it has no Linear
    (``from_flax`` maps no 2-D kernel); a source with another layout gets
    its rule here, by ``name`` and rank, as the JAX converter's
    ``torch_tensor_to_flax`` transposes to HWIO."""
    return torch.as_tensor(tensor).detach().to("cpu", torch.float32).clone()


def default_key_map(torch_key: str) -> str | None:
    """The identity: a dump in tpuflow's own naming has the port's keys."""
    return torch_key


def convert_state_dict(
    state_dict: dict, key_map: Callable[[str], str | None] = default_key_map
) -> dict[str, torch.Tensor]:
    """A dump's tensors (or arrays) under the port's keys, float32 on the
    CPU; keys that ``key_map`` maps to None are skipped."""
    out = {}
    for key, value in state_dict.items():
        name = key_map(key)
        if name is not None:
            out[name] = torch_tensor_to_port(name, value)
    return out


def validate(converted: dict[str, torch.Tensor], model: torch.nn.Module
             ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Match ``converted`` against ``model.state_dict()``: returns (the state
    dict to load, in the model's dtypes on the CPU, with ActNorm's
    ``initialized`` set where the dump has none; the problems: missing
    parameters and buffers, shape mismatches, unexpected keys). No
    problems means an exact match."""
    target = model.state_dict()
    buffers = {name for name, _ in model.named_buffers()}
    state, problems = {}, []
    for key, want in target.items():
        got = converted.get(key)
        if got is None and key.rsplit(".", 1)[-1] == "initialized":
            got = torch.ones((), dtype=torch.bool)
        if got is None:
            kind = "buffer" if key in buffers else "parameter"
            problems.append(f"missing {kind}: {key} {tuple(want.shape)}")
        elif tuple(got.shape) != tuple(want.shape):
            problems.append(f"shape mismatch {key}: got {tuple(got.shape)}, "
                            f"want {tuple(want.shape)}")
        else:
            state[key] = got.to(want.dtype)
    problems += [f"unexpected: {key}" for key in converted if key not in target]
    return state, problems


def norm_stats(blob, cfg) -> dict[str, torch.Tensor]:
    """The normalization constants: a ``norm`` dict shipped in the blob,
    else the configured dataset's training split, as training computes
    them."""
    if isinstance(blob, dict) and isinstance(blob.get("norm"), dict):
        norm = {k: np.asarray(blob["norm"][k], np.float32) for k in NORM_KEYS}
    else:
        from tpuflow_torch.data import load_dataset

        norm = load_dataset(cfg.data, cfg.model, "train").norm.to_dict()
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in norm.items()}


def main(argv: list[str] | None = None) -> None:
    from tpuflow_torch.cli import parse_args
    from tpuflow_torch.device import resolve_device
    from tpuflow_torch.models import TMGlow
    from tpuflow_torch.train.checkpoint import Checkpointer
    from tpuflow_torch.train.step import make_optimizer

    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3:
        print(__doc__)
        raise SystemExit(2)
    in_path, out_dir = argv[0], argv[1]
    cfg, device = parse_args(argv[2:], prog=PROG)
    dev = resolve_device(device)

    blob = torch.load(in_path, map_location="cpu", weights_only=False)
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    # A flat blob may carry the norm dict beside the tensors.
    state_dict = {k: v for k, v in state_dict.items() if k != "norm"}
    model = TMGlow(cfg.model, device=dev, seed=cfg.train.seed)
    state, problems = validate(convert_state_dict(state_dict), model)
    if problems:
        print("conversion mismatches (first 20):")
        for p in problems[:20]:
            print(" ", p)
        raise SystemExit(1)
    model.load_state_dict(state)

    # A fresh optimizer and scheduler: a converted checkpoint restarts
    # optimization (torch Adam moments of another model do not carry over).
    opt, sched = make_optimizer(model.parameters(), cfg.train.lr, cfg.train.lr_decay,
                                cfg.train.weight_decay)
    out = Checkpointer(out_dir).save(0, {
        "model": {k: v.cpu() for k, v in model.state_dict().items()},
        "optimizer": opt.state_dict(),
        "scheduler": sched.state_dict(),
        "norm": norm_stats(blob, cfg),
        "meta": {"source": str(in_path), "epoch": 0, "global_step": 0,
                 "config": dataclasses.asdict(cfg)},
    })
    print(f"converted {len(state_dict)} tensors -> {out} "
          "(full checkpoint: model/optimizer/scheduler/norm/meta)")


if __name__ == "__main__":
    main()
