"""``examples/quickstart_torch.py``, the port's walkthrough, on the CPU.

Its overrides are the JAX walkthrough's (``examples/quickstart.py``) and
exist in the port's config schema; the metric keys it reads exist in what
the CLIs return; one run end to end in a temporary directory writes each
step's outputs (checkpoints, rollout stats and figures, the evaluation,
the recalibrated rollout, the report, the exported artifact and a served
rollout). Without ``--device cpu`` and without CUDA it raises
(``tests/test_torch_port.py``).
"""

import ast
import dataclasses
import importlib.util
import json
import pathlib
import re

import numpy as np
import torch

from tpuflow_torch.configs.config import CaseConfig
from tpuflow_torch.eval.metrics import METRIC_KEYS, key_structure

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "examples" / "quickstart_torch.py"


def _quickstart():
    spec = importlib.util.spec_from_file_location("quickstart_torch", SOURCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _overrides(path: pathlib.Path) -> set[str]:
    """The dotted ``key=value`` strings of a walkthrough's source (an
    f-string contributes its literal head, ``key=``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        text = None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        elif isinstance(node, ast.JoinedStr) and isinstance(node.values[0], ast.Constant):
            text = node.values[0].value
        if text and "=" in text:
            key = text.split("=", 1)[0]
            if "." in key and key.replace(".", "").replace("_", "").isalnum():
                out.add(text)
    return out


def test_quickstart_overrides_are_the_jax_walkthroughs_and_in_the_schema():
    port = _overrides(SOURCE)
    assert port == _overrides(ROOT / "examples" / "quickstart.py")
    keys = {o.split("=", 1)[0] for o in port}
    assert len(keys) > 10, keys
    cfg = CaseConfig()
    schema = {f"{sect.name}.{leaf.name}"
              for sect in dataclasses.fields(cfg)
              if dataclasses.is_dataclass(getattr(cfg, sect.name))
              for leaf in dataclasses.fields(getattr(cfg, sect.name))}
    assert keys <= schema, keys - schema


def test_quickstart_runs_end_to_end_on_the_cpu(tmp_path):
    out = _quickstart().main([str(tmp_path), "--device", "cpu"])

    # The keys the walkthrough reads exist in what the CLIs return.
    src = SOURCE.read_text()
    for var in ("train", "roll", "ev"):
        used = set(re.findall(rf"\b{var}\['(\w+)'\]", src))
        assert used, f"the walkthrough no longer reads {var}[...]?"
        assert used <= set(out[var]), used - set(out[var])
    assert set(re.findall(r'"(coverage_holdout_\w+)"', src)) <= set(out["ev"])

    case = "backward-step"
    ckpt, ev_dir = tmp_path / "ckpt" / case, tmp_path / "eval" / case
    # 1. Training: 8 epochs, a checkpoint every 4.
    assert out["train"]["epoch"] == 8 and np.isfinite(out["train"]["mean_bpd"])
    assert {"ckpt_00000004.pt", "ckpt_00000008.pt", "train_log.csv"} <= {
        p.name for p in ckpt.iterdir()}
    # 2. The rollout: stats, metrics and figures.
    assert out["roll"]["steps"] == 8 and out["roll"]["n_samples"] == 8
    with np.load(ev_dir / "rollout_stats.npz") as f:
        assert set(f.files) == {"mean", "var"}
        assert f["mean"].shape == (8, 16, 32, 3) and np.isfinite(f["mean"]).all()
    assert {"rollout_metrics.json", "tke.png", "pred_t0000_u.png"} <= {
        p.name for p in ev_dir.iterdir()}
    # 3. The evaluation: the JAX evaluator's keys, its artefacts.
    assert key_structure(out["ev"]) == METRIC_KEYS and out["ev"]["backend"] == "cpu"
    assert json.loads((ev_dir / "eval_metrics.json").read_text()) == out["ev"]
    assert {"spread_field.npy", "spectral_filter.npz", "quantile_map.npz"} <= {
        p.name for p in ev_dir.iterdir()}
    # 4. The recalibrated rollout: var_calibrated = var x spread_scale^2.
    with np.load(tmp_path / "eval_recalibrated" / case / "rollout_stats.npz") as f:
        np.testing.assert_allclose(f["var_calibrated"],
                                   f["var"] * out["ev"]["spread_scale"] ** 2, rtol=1e-6)
    # 5. The report.
    assert out["report"] == ev_dir / "report.md"
    assert "test NLL (bits/dim)" in out["report"].read_text()
    # 6. Export + serve, on the CPU: the served rollout is finite and shaped.
    assert out["artifact"] == ev_dir / "rollout.torchexport" and out["artifact"].exists()
    meta = json.loads((ev_dir / "rollout.meta.json").read_text())
    assert meta["platforms"] == ["cpu"] and meta["spread_scale"] == out["ev"]["spread_scale"]
    for k in ("mean", "var"):
        assert out["served"][k].shape == (8, 16, 32, 3) and np.isfinite(out["served"][k]).all()
