"""The port's rollout CLI, ``python -m tpuflow_torch.cli.rollout``, on the
CPU at a small size: it loads a checkpoint the port's trainer wrote,
wrap-tiles the LF input past the stored steps, and writes
``rollout_stats.npz`` and ``rollout_metrics.json`` with the key sets of
the JAX package's ``tpuflow/cli/rollout.py`` (its ``step_timer`` adds
``rollout_steps_per_sec_seconds``; its npz holds ``var_calibrated`` only
when a spread is set). It refuses a missing checkpoint unless
``eval.allow_untrained=true``, and with no ``--device`` it asks for the
GPU.
"""

import json

import numpy as np
import pytest
import torch

from tpuflow_torch.cli.rollout import main as rollout_main
from tpuflow_torch.cli.train import main as train_main
from tpuflow_torch.configs import load_case, parse_cli_overrides
from tpuflow_torch.data import load_dataset
from tpuflow_torch.eval import load_eval_bundle, make_ensemble_rollout
from tpuflow_torch.train import Checkpointer

torch.set_num_threads(1)

JAX_METRICS_KEYS = {"rollout_steps_per_sec", "rollout_steps_per_sec_seconds", "steps",
                    "n_samples", "temperature", "backend"}


def _args(tmp_path, *extra):
    return [
        "backward-step",
        "model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
        "model.coupling_layers=2", "model.growth_rate=4", "model.encoder_width=8",
        "model.lstm_hidden=8", "model.cond_channels=8", "model.hf_shape=16,32",
        "model.lf_shape=4,8", "model.compute_dtype=float32",
        "data.n_train_traj=2", "data.n_test_traj=1", "data.train_steps=4",
        "data.batch_size=2", "data.window=2", "train.epochs=1", "train.log_every=0",
        f"train.checkpoint_dir={tmp_path}/ckpt", f"eval.output_dir={tmp_path}/eval",
        "eval.rollout_steps=6", "eval.n_samples=3", *extra, "--device", "cpu",
    ]


@pytest.fixture
def trained(tmp_path):
    train_main(_args(tmp_path))
    return tmp_path


def _outputs(tmp_path):
    out = tmp_path / "eval" / "backward-step"
    return (np.load(out / "rollout_stats.npz"),
            json.loads((out / "rollout_metrics.json").read_text()))


def test_cli_rollout_writes_stats_and_metrics(trained, capsys):
    metrics = rollout_main(_args(trained))
    assert "LF input wrap-tiled" in capsys.readouterr().out  # 6 steps > 4 stored
    stats, saved = _outputs(trained)
    # The port adds how many devices the members split over.
    assert set(saved) == JAX_METRICS_KEYS | {"devices"} and saved == metrics
    assert saved["steps"] == 6 and saved["n_samples"] == 3 and saved["backend"] == "cpu"
    assert saved["devices"] == 1
    assert saved["temperature"] == 0.85 and saved["rollout_steps_per_sec"] > 0
    assert set(stats.files) == {"mean", "var"}
    for k in ("mean", "var"):
        assert stats[k].shape == (6, 16, 32, 3) and np.isfinite(stats[k]).all()
    assert (stats["var"] >= 0).all()
    # The timed run (seed 1) over the wrap-tiled LF input, denormalized
    # with the checkpoint's constants.
    cfg = load_case("backward-step", parse_cli_overrides(_args(trained)[1:-2]))
    model, norm, _ = load_eval_bundle(cfg, device="cpu")
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    lf = np.concatenate([ds.lf[0], ds.lf[0]])[:6]
    want = make_ensemble_rollout(model, 3, 0.85)(torch.from_numpy(lf),
                                                 torch.Generator().manual_seed(1))
    np.testing.assert_allclose(stats["mean"], ds.denorm_hf(want["mean"].numpy()), rtol=1e-6)
    np.testing.assert_allclose(stats["var"], ds.denorm_hf_var(want["var"].numpy()), rtol=1e-6)


def test_cli_rollout_spread_redraw_and_learned_tau(trained):
    rollout_main(_args(trained))
    stats0, _ = _outputs(trained)
    rollout_main(_args(trained, "eval.spread_scale=2.0"))
    stats, saved = _outputs(trained)
    assert set(stats.files) == {"mean", "var", "var_calibrated"}
    np.testing.assert_array_equal(stats["var_calibrated"], stats["var"] * 4.0)
    # The rollout's seeds are fixed: the same stats as without the spread.
    np.testing.assert_array_equal(stats["var"], stats0["var"])
    assert saved["temperature"] == 0.85
    field = trained / "spread.npy"
    np.save(field, np.full((16, 32, 3), 3.0, np.float32))
    rollout_main(_args(trained, f"eval.spread_field={field}", "eval.spread_scale=2.0"))
    stats, _ = _outputs(trained)
    np.testing.assert_allclose(stats["var_calibrated"], stats["var"] * 9.0, rtol=1e-6)
    np.save(field, np.ones((16, 16, 3), np.float32))
    with pytest.raises(ValueError, match="spread_field shape"):
        rollout_main(_args(trained, f"eval.spread_field={field}"))
    # No member overflows here, so the redraw changes nothing.
    rollout_main(_args(trained, "eval.overflow_redraw=true"))
    stats, _ = _outputs(trained)
    np.testing.assert_array_equal(stats["mean"], stats0["mean"])

    # A learned per-scale tau in the checkpoint's meta is the deployed one,
    # and an explicit override beats it.
    ck = Checkpointer(trained / "ckpt" / "backward-step")
    state = ck.restore()
    state["meta"]["learned_tau"] = [0.8, 0.75]
    ck.save(ck.latest_step(), state)
    assert rollout_main(_args(trained))["temperature"] == pytest.approx([0.8, 0.75])
    over = rollout_main(_args(trained, "eval.temperature_scales=0.5,0.6"))
    assert over["temperature"] == pytest.approx([0.5, 0.6])


def test_cli_rollout_refuses_a_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="allow_untrained"):
        rollout_main(_args(tmp_path))
    metrics = rollout_main(_args(tmp_path, "eval.allow_untrained=true", "eval.rollout_steps=2"))
    stats, _ = _outputs(tmp_path)
    assert metrics["steps"] == 2 and stats["mean"].shape == (2, 16, 32, 3)


def test_cli_rollout_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout_main(_args(tmp_path)[:-2])
