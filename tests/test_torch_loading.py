"""Loading committed weights into the port: ``tools/export_to_torch.py``
(a JAX Orbax checkpoint -> a port checkpoint), the port's
``load_eval_bundle`` and ``resolve_temperature``, and the dataset's
normalization helpers, against the JAX package.

The flagship test restores ``runs/r5_v3_deep_ft`` (Orbax, step 16, with a
fine-tuned per-scale ``learned_tau``) through the exporter into a
temporary directory, loads it with the port, and runs 2 members x 2
steps at float32 on both sides with JAX's draws handed to the port as
``eps``: within 1e-4 x max(1, max |ref|), as the port's other rollout
parity tests.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.configs.config import load_case as j_load_case
from tpuflow.data.dataset import NormStats as JNormStats
from tpuflow.data.dataset import TrajectoryDataset as JTrajectoryDataset
from tpuflow.eval.loading import load_eval_bundle as j_load_eval_bundle
from tpuflow.eval.loading import resolve_temperature as j_resolve_temperature
from tpuflow.eval.rollout import make_ensemble_rollout as j_make_ensemble_rollout
from tpuflow_torch.configs import load_case
from tpuflow_torch.data import NormStats, TrajectoryDataset, load_dataset
from tpuflow_torch.eval import load_eval_bundle, make_ensemble_rollout, resolve_temperature
from tpuflow_torch.models import TMGlow, latent_shapes
from tpuflow_torch.train import Checkpointer, Trainer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "runs" / "r5_v3_deep_ft" / "checkpoints"
TOL = 1e-4


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_to_torch", ROOT / "tools" / "export_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_eps(key, cfg, n, steps):
    """JAX's draws of a rollout: split(key) per step, split(sub, L) per
    scale, one normal draw per scale."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, cfg.n_scales)
        out.append([torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
                    for k, s in zip(keys, latent_shapes(cfg, n))])
    return out


def test_flagship_export_loads_and_matches_jax(tmp_path):
    out = _exporter().export("backward-step", FLAGSHIP, tmp_path, step=16)
    assert out == tmp_path / "backward-step" / "ckpt_00000016.pt"
    saved = Checkpointer(tmp_path / "backward-step").restore(16)
    assert set(saved) == {"model", "norm", "meta"}  # no optimizer state
    assert saved["meta"]["source"] == str(FLAGSHIP)

    over = {"train.checkpoint_dir": str(tmp_path), "model.compute_dtype": "float32"}
    cfg = load_case("backward-step", over)
    model, norm, meta = load_eval_bundle(cfg, device="cpu")
    jcfg = j_load_case("backward-step", {**over, "train.checkpoint_dir": str(FLAGSHIP)})
    jm, v, jnorm, jmeta = j_load_eval_bundle(jcfg)
    for k in ("epoch", "global_step", "learned_tau", "config"):
        assert meta[k] == jmeta[k], k
    tau = resolve_temperature(cfg, meta, device="cpu")
    tau_j = j_resolve_temperature(jcfg, jmeta)
    assert tau.dtype == torch.float32 and tau.shape == (3,)
    np.testing.assert_array_equal(tau.numpy(), np.asarray(tau_j))
    np.testing.assert_allclose(tau.numpy(), [0.8697, 0.8609, 0.8646], atol=1e-4)
    for k, a in jnorm.to_dict().items():
        np.testing.assert_array_equal(norm.to_dict()[k], a)

    # 2 members x 2 steps at f32 on the test split's first LF frames.
    lf = load_dataset(cfg.data, cfg.model, "test", norm=norm).lf[0, :2]
    key = jax.random.PRNGKey(0)
    want = j_make_ensemble_rollout(jm, 2, tau_j, "fields")(v, jnp.asarray(lf), key)
    got = make_ensemble_rollout(model, 2, tau, "fields")(
        torch.from_numpy(lf), eps=_jax_eps(key, model.cfg, 2, 2))
    want = np.asarray(want)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))

    # Training refuses to resume from weights without an optimizer state.
    tcfg = load_case("backward-step", {**over, "data.n_train_traj": 1, "data.train_steps": 8,
                                       "data.batch_size": 1})
    with pytest.raises(ValueError, match="no optimizer state"):
        Trainer(tcfg, device="cpu").init_or_resume()


TINY = {"model.n_scales": 2, "model.n_flow_steps": 2, "model.hf_shape": "16,32",
        "model.lf_shape": "4,8", "model.coupling_width": 8, "model.coupling_layers": 2,
        "model.growth_rate": 4, "model.encoder_width": 8, "model.lstm_hidden": 8,
        "model.cond_channels": 8, "model.compute_dtype": "float32"}


def _save(tmp_path, model, step=3, meta=None):
    norm = NormStats(*(np.full(3, v, np.float32) for v in (0.1, 2.0, -0.5, 3.0)))
    Checkpointer(tmp_path / "backward-step").save(step, {
        "model": model.state_dict(),
        "norm": {k: torch.from_numpy(v) for k, v in norm.to_dict().items()},
        "meta": {"epoch": step, **(meta or {})},
    })
    return norm


def test_load_eval_bundle_reads_the_ports_checkpoint(tmp_path, capsys):
    cfg = load_case("backward-step", {**TINY, "train.checkpoint_dir": str(tmp_path)})
    src = TMGlow(cfg.model, device="cpu", seed=5)
    norm = _save(tmp_path, src, step=3)
    _save(tmp_path, TMGlow(cfg.model, device="cpu", seed=6), step=7,
          meta={"config": {"data": {"fixture_version": 2}}})
    model, got_norm, meta = load_eval_bundle(cfg, step=3, device="cpu")
    assert meta == {"epoch": 3}
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    for k, v in norm.to_dict().items():
        np.testing.assert_array_equal(got_norm.to_dict()[k], v)
    assert "loaded checkpoint step 3" in capsys.readouterr().out
    _, _, meta = load_eval_bundle(cfg, device="cpu")  # the latest, step 7
    assert meta["epoch"] == 7
    assert "WARNING: checkpoint was trained on fixture v2" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="step 5"):
        load_eval_bundle(cfg, step=5, device="cpu")


def test_load_eval_bundle_refuses_a_missing_checkpoint(tmp_path, capsys):
    over = {**TINY, "train.checkpoint_dir": str(tmp_path / "none")}
    with pytest.raises(FileNotFoundError, match="allow_untrained"):
        load_eval_bundle(load_case("backward-step", over), device="cpu")
    assert not (tmp_path / "none").exists()
    cfg = load_case("backward-step", {**over, "eval.allow_untrained": "true"})
    model, norm, meta = load_eval_bundle(cfg, device="cpu")
    assert norm is None and meta == {}
    assert "using fresh init" in capsys.readouterr().out
    fresh = TMGlow(cfg.model, device="cpu", seed=cfg.train.seed)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("scales, meta", [
    ("", {}),
    ("", {"learned_tau": [0.9, 0.8]}),
    ("0.7,0.75", {"learned_tau": [0.9, 0.8]}),
    ("0.7", {}),
    ("", {"learned_tau": [0.9, 0.8, 0.7]}),
])
def test_resolve_temperature_matches_jax(scales, meta):
    over = {**TINY, "eval.temperature_scales": scales}
    cfg, jcfg = load_case("backward-step", over), j_load_case("backward-step", over)
    try:
        want = j_resolve_temperature(jcfg, meta)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            resolve_temperature(cfg, meta, device="cpu")
        return
    got = resolve_temperature(cfg, meta, device="cpu")
    if isinstance(want, float):
        assert isinstance(got, float) and got == want
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_norm_stats_and_denorm_match_jax():
    rng = np.random.default_rng(0)
    lf = rng.standard_normal((2, 3, 4, 8, 3)).astype(np.float32) * 2 + 1
    hf = rng.standard_normal((2, 3, 16, 32, 3)).astype(np.float32) * 3 - 1
    ds, jds = TrajectoryDataset(lf, hf), JTrajectoryDataset(lf, hf)
    d = {k: torch.from_numpy(v) for k, v in ds.norm.to_dict().items()}
    assert dataclasses.asdict(NormStats.from_dict(d)).keys() == ds.norm.to_dict().keys()
    for k, v in JNormStats.from_dict(jds.norm.to_dict()).to_dict().items():
        np.testing.assert_array_equal(NormStats.from_dict(d).to_dict()[k], v)
    x = rng.standard_normal((5, 16, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(ds.denorm_hf(x), jds.denorm_hf(x), rtol=1e-6)
    np.testing.assert_allclose(ds.denorm_hf_var(x**2), jds.denorm_hf_var(x**2), rtol=1e-6)
    np.testing.assert_allclose(ds.denorm_lf(x), jds.denorm_lf(x), rtol=1e-6)
    np.testing.assert_allclose(ds.denorm_hf(ds.hf), hf, atol=1e-5)
    np.testing.assert_allclose(ds.denorm_hf_var(np.ones(3, np.float32)),
                               (hf.std(axis=(0, 1, 2, 3)) + 1e-8) ** 2, rtol=1e-5)
