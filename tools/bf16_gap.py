"""Held-out bits/dim of a committed JAX checkpoint at bfloat16, in each of
the coupling's two numerics (``model.use_pallas`` false and true), from the
PyTorch port and from the JAX package.

    python tools/bf16_gap.py [--steps 8] [--checkpoint oracle|flagship|cylinder]
    XLA_FLAGS=--xla_allow_excess_precision=false python tools/bf16_gap.py

For each checkpoint below (by default the evaluator oracle's and the
flagship, both backward-step; ``--checkpoint cylinder`` adds the
fine-tuned cylinder-array one), restored on the CPU: the test split of
the case preset (4 trajectories,
the checkpoint's fixture version, the first ``--steps`` steps),
teacher-forced from a zero ConvLSTM state (``make_nll_eval``), mean over
steps and trajectories, with the model's bf16 coupling nets:

  * "jax_default": ``tpuflow`` as the checkpoint was trained and evaluated
    (``use_pallas: false``; every conv's output is rounded to bf16);
  * "port_default": ``tpuflow_torch`` at ``use_pallas: false`` on the
    checkpoint exported by ``tools/export_to_torch.py`` (the same rounding
    in K2's plain version), the checkpoint's own numerics;
  * "jax_fused": ``tpuflow`` with ``use_pallas: true`` and the fused
    coupling's CPU path, ``kernels.coupling_fused.xla_reference`` (what
    the Pallas kernel computes: f32 sums, bf16 only at the conv inputs,
    the weights and the relu features);
  * "port_fused": ``tpuflow_torch`` at ``use_pallas: true``.

Each port number stands beside its JAX counterpart
(``rel_port_default_vs_jax_default``, ``rel_port_fused_vs_jax_fused``);
``gap_jax_fused_vs_default`` is how far the two numerics lie apart.

Under ``jax.jit`` XLA's CPU compiler may keep a bf16 intermediate at f32
inside a fusion instead of rounding it where the program says (its
``xla_allow_excess_precision``, on by default), which moves both JAX
numbers; with that flag off, JAX computes the program as written, op by
op rounding included, which the port follows. Run the tool both ways;
each JSON line records the setting.

It prints one JSON line per checkpoint. Like ``export_to_torch.py``, it
imports both packages and runs where JAX is; nothing in ``tpuflow_torch``
imports it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASE = "backward-step"
CHECKPOINTS = {
    # tpuflow/tools/make_eval_oracle.py: the oracle's checkpoint, fixture v2.
    "oracle": ROOT / "runs" / "r4_bstep_deeper" / "checkpoints",
    # The round-5 flagship, fixture v3.
    "flagship": ROOT / "runs" / "r5_v3_deep_ft" / "checkpoints",
    # The fine-tuned cylinder-array checkpoint, fixture v2.
    "cylinder": ROOT / "runs" / "r5_cyl_ft" / "checkpoints",
}
# Each checkpoint's case; backward-step where not listed.
CASES = {"cylinder": "cylinder-array"}


@contextlib.contextmanager
def jax_fused_path():
    """Route every JAX coupling through the fused coupling's CPU path
    (``xla_reference``) while ``model.use_pallas`` is set."""
    import tpuflow.flows.coupling as jcoupling

    available = jcoupling.fused_available
    jcoupling.fused_available = lambda: True
    try:
        yield
    finally:
        jcoupling.fused_available = available


def jax_bpds(orbax_dir, steps: int, fused: bool, case: str = CASE):
    """The JAX package's held-out bits/dim per step and trajectory, (T, B),
    on its own checkpoint of ``case``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpuflow.configs.config import load_case
    from tpuflow.data.dataset import load_dataset
    from tpuflow.eval.loading import load_eval_bundle
    from tpuflow.eval.rollout import make_nll_eval

    over = {"train.checkpoint_dir": str(orbax_dir), "model.use_pallas": fused}
    cfg = load_case(case, over)
    model, variables, norm, meta = load_eval_bundle(cfg)
    fx = meta["config"]["data"]["fixture_version"]
    cfg = load_case(case, {**over, "data.fixture_version": fx})
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    with jax_fused_path() if fused else contextlib.nullcontext():
        bpds = jax.jit(make_nll_eval(model))(variables, jnp.asarray(ds.lf[:, :steps]),
                                             jnp.asarray(ds.hf[:, :steps]))
        return np.asarray(bpds)


def jax_bpd(orbax_dir, steps: int, fused: bool, case: str = CASE) -> float:
    """The mean of :func:`jax_bpds`."""
    return float(jax_bpds(orbax_dir, steps, fused, case).mean())


def port_bpd(torch_dir, fixture_version: int, steps: int, fused: bool,
             case: str = CASE) -> float:
    """The port's held-out bits/dim on an exported checkpoint, on the CPU,
    in the numerics ``fused`` selects."""
    import torch

    from tpuflow_torch.configs import load_case
    from tpuflow_torch.data import load_dataset
    from tpuflow_torch.eval import load_eval_bundle, make_nll_eval

    cfg = load_case(case, {"train.checkpoint_dir": str(torch_dir),
                           "data.fixture_version": fixture_version,
                           "model.use_pallas": fused})
    model, norm, _ = load_eval_bundle(cfg, device="cpu")
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    bpds = make_nll_eval(model)(torch.from_numpy(ds.lf[:, :steps]),
                                torch.from_numpy(ds.hf[:, :steps]))
    return float(bpds.numpy().mean())


def four_way(orbax_dir, steps: int = 8, torch_dir=None, case: str = CASE) -> dict:
    """{"jax_default", "port_default", "jax_fused", "port_fused"} bits/dim
    and the gaps between them. ``torch_dir`` holds the exported checkpoint
    (one is exported into a temporary directory if None)."""
    import torch

    sys.path.insert(0, str(ROOT / "tools"))
    from export_to_torch import export

    from tpuflow_torch.train import Checkpointer

    out = {"jax_default": jax_bpd(orbax_dir, steps, False, case),
           "jax_fused": jax_bpd(orbax_dir, steps, True, case)}
    with tempfile.TemporaryDirectory(prefix="bf16_gap_") as tmp:
        if torch_dir is None:
            torch_dir = tmp
            export(case, orbax_dir, torch_dir)
        meta = Checkpointer(pathlib.Path(torch_dir) / case).restore(map_location="cpu")["meta"]
        fx = meta["config"]["data"]["fixture_version"]
        with torch.no_grad():
            for name in ("default", "fused"):
                out[f"port_{name}"] = port_bpd(torch_dir, fx, steps, name == "fused", case)
    out["gap_jax_fused_vs_default"] = abs(out["jax_fused"] - out["jax_default"])
    for name in ("default", "fused"):
        want = out[f"jax_{name}"]
        out[f"rel_port_{name}_vs_jax_{name}"] = abs(out[f"port_{name}"] - want) / abs(want)
    return out


def excess_precision() -> bool:
    """Whether XLA may keep bf16 intermediates at f32 (its default)."""
    return "--xla_allow_excess_precision=false" not in os.environ.get("XLA_FLAGS", "")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8, help="test steps per trajectory (default 8)")
    ap.add_argument("--checkpoint", choices=sorted(CHECKPOINTS), action="append",
                    help="one checkpoint (repeatable; default: oracle and flagship)")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    results = {}
    for name in args.checkpoint or ("oracle", "flagship"):
        orbax_dir, case = CHECKPOINTS[name], CASES.get(name, CASE)
        results[name] = {"checkpoint": str(orbax_dir.relative_to(ROOT)), "case": case,
                         "steps": args.steps, "xla_allow_excess_precision": excess_precision(),
                         **four_way(orbax_dir, args.steps, case=case)}
        print(json.dumps({name: results[name]}), flush=True)
    return results


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
