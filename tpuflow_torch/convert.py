"""Weight bridge: a Flax variable tree of the JAX package -> a state_dict
of the port.

The port names every tensor by its Flax path joined with ``.``, so the
mapping is one leaf to one tensor: conv ``kernel`` leaves (HWIO) become
``weight`` tensors (OIHW); every other leaf keeps its name and shape.
Both collections cross: ``params`` and ``buffers`` (the inv-1x1's fixed
``p`` and ``sign_s``). Arrays arrive as numpy (e.g. through
``jax.device_get``); nothing here imports JAX.

The port's one buffer without a Flax leaf, ActNorm's ``initialized``
flag, is set: a Flax tree's ActNorm leaves come from ``model.init``,
which initialises them from data.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_COLLECTIONS = ("params", "buffers")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def from_flax(variables: Mapping[str, Any], model: nn.Module) -> dict[str, torch.Tensor]:
    """Map ``variables`` ({"params": ..., "buffers": ...} of numpy arrays)
    onto ``model``'s state_dict keys, on the model's devices and dtypes.

    Raises ``KeyError`` listing every model key the tree does not supply
    and every leaf the model does not use, and ``ValueError`` on a shape
    mismatch; load the result with ``model.load_state_dict``.
    """
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    leaves: dict[str, Any] = {}
    for coll in _COLLECTIONS:
        for key, arr in _flatten(variables.get(coll, {})).items():
            arr = np.asarray(arr)
            if key.endswith(".kernel") or key == "kernel":
                key = key[: -len("kernel")] + "weight"
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
            if key in leaves:
                raise KeyError(f"leaf {key!r} appears in more than one collection")
            leaves[key] = arr
    target = model.state_dict()
    for key in target:
        if key.split(".")[-1] == "initialized" and key not in leaves:
            leaves[key] = np.ones((), np.bool_)
    missing = sorted(set(target) - set(leaves))
    unused = sorted(set(leaves) - set(target))
    if missing or unused:
        raise KeyError(f"from_flax: missing keys {missing}; unused keys {unused}")
    out = {}
    for key, ref in target.items():
        arr = leaves[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"from_flax: {key} has shape {tuple(arr.shape)}, model expects "
                f"{tuple(ref.shape)}"
            )
        out[key] = torch.tensor(arr).to(ref.device, ref.dtype)
    return out
