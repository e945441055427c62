"""bf16 numerics on trained weights: the port's held-out bits/dim against
the JAX package's, on the evaluator oracle's checkpoint and on the
flagship (``tools/bf16_gap.py``: the test split's first 8 steps, 4
trajectories, the preset's bf16 nets), in each of the coupling's two
numerics, each against its JAX counterpart to 1e-3 relative:

  * ``use_pallas: false``, the checkpoints' own: the port against JAX's
    default bf16 path (every conv output and sum rounded to bf16, as both
    checkpoints were trained and evaluated);
  * ``use_pallas: true``: the port against JAX's fused numerics
    (``use_pallas`` with ``xla_reference``; f32 accumulation, bf16 only at
    the conv inputs, the weights and the relu features).

JAX runs in a subprocess with ``--xla_allow_excess_precision=false``:
with XLA's default, its CPU compiler keeps some bf16 intermediates at
f32 inside a fusion under ``jax.jit``, which moves JAX's bits/dim away
from the program as written by up to 1.5e-3 relative (the flagship,
measured); with the flag off, JAX computes what its code says, op by op
rounding included.

On the flagship, the port's default-path number is also the one the card
checks: the committed ``weights/r5_v3_deep_ft/reference.json`` (written by
``tpuflow_torch.tools.weights_reference`` from the committed export, on
the CPU) must hold it bit for bit, the CPU's computation being
deterministic (one thread or eight, measured).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-3


@pytest.mark.parametrize("checkpoint", ["oracle", "flagship"])
def test_port_bf16_bpd_matches_jax_fused_numerics(checkpoint):
    env = {**os.environ, "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "tools/bf16_gap.py", "--checkpoint", checkpoint],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads([line for line in out.stdout.splitlines() if line.startswith("{")][-1])
    r = res[checkpoint]
    assert r["xla_allow_excess_precision"] is False and r["steps"] == 8
    assert r["rel_port_fused_vs_jax_fused"] <= TOL, r
    assert r["rel_port_default_vs_jax_default"] <= TOL, r
    if checkpoint == "flagship":
        ref = json.loads((ROOT / "weights" / "r5_v3_deep_ft" / "reference.json").read_text())
        assert ref["bpd"]["steps"] == r["steps"] and ref["bpd"]["dtype"] == "bfloat16"
        assert ref["bpd"]["use_pallas"] is False
        assert ref["bpd"]["value"] == r["port_default"], (ref["bpd"], r["port_default"])
