"""The port's evaluator, ``python -m tpuflow_torch.cli.evaluate``, and the
rollout CLI's figures, against the JAX package.

  * Whole-evaluator parity: ``tpuflow.cli.evaluate.main`` and the port's
    ``main`` on shared weights (``tpuflow_torch.convert.from_flax``) of a
    tiny f32 model and the synthetic fixture. Each side's rollout
    factories (``make_batched_ensemble_rollout``, ``members_fn_factory``)
    are monkeypatched to return the same arrays, since the two packages'
    random draws differ by design. Every key of ``eval_metrics.json``
    then agrees at 1e-4 relative (1e-6 absolute near 0), ``test_bpd``
    included (the real held-out NLL on the shared weights), and so do
    the three calibration artefacts and the figures' file names.
  * The committed oracle (``runs/r5_eval_oracle``): its checkpoint
    (``runs/r4_bstep_deeper``) through ``tools/export_to_torch.py``,
    evaluated by the port with the oracle's own overrides at the preset's
    bf16. Key set and nesting equal; the sample-free numbers equal at
    1e-4 relative; ``test_bpd`` within JAX's own gap between its fused
    numerics and its default bf16 path (measured here) plus 1e-3
    relative: the port computes the fused numerics, the oracle was
    evaluated on the default path (``tools/bf16_gap.py``). The same
    evaluation is held to the port's own committed oracle
    (``runs/r5_eval_oracle_torch``, ``tpuflow_torch.tools.make_eval_oracle``
    on the CPU, one thread, from the same checkpoint committed in the port's
    format): every value of ``eval_metrics.json`` and every artefact array
    bit for bit, since the port's CPU evaluation is deterministic (repeated
    runs in separate processes wrote identical files).
"""

import importlib.util
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.cli.evaluate as j_evaluate
import tpuflow.cli.rollout as j_rollout
import tpuflow_torch.cli.evaluate as t_evaluate
import tpuflow_torch.cli.rollout as t_rollout
import tpuflow_torch.tools.make_eval_oracle as t_make_eval_oracle
from tpuflow.cli import parse_args as j_parse_args
from tpuflow.models.tmglow import TMGlow as JTMGlow
from tpuflow.models.tmglow import init_lstm_state as j_init_lstm_state
from tpuflow.tools.make_eval_oracle import ORACLE_CASE, ORACLE_OVERRIDES
from tpuflow_torch.convert import from_flax
from tpuflow_torch.eval.metrics import METRIC_KEYS, key_structure
from tpuflow_torch.models import TMGlow

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE_DIR = ROOT / "runs" / "r5_eval_oracle" / ORACLE_CASE
PORT_ORACLE_DIR = ROOT / "runs" / "r5_eval_oracle_torch" / ORACLE_CASE
ORACLE_CKPT = ROOT / "runs" / "r4_bstep_deeper" / "checkpoints"
RTOL, ATOL = 1e-4, 1e-6
BF16_TOL = 1e-3  # port vs JAX's fused numerics, relative (tools/bf16_gap.py)

TINY = [
    "model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
    "model.coupling_layers=2", "model.growth_rate=4", "model.encoder_width=8",
    "model.lstm_hidden=8", "model.cond_channels=8", "model.hf_shape=16,32",
    "model.lf_shape=4,8", "model.compute_dtype=float32",
    "data.n_train_traj=2", "data.n_test_traj=3", "data.train_steps=6",
    "eval.rollout_steps=6", "eval.n_samples=3", "eval.calibration_steps=4",
    "eval.ref_steps=12", "eval.traj_batch=2",
]
N_TRAJ, N, T_CAL, HF = 3, 3, 4, (16, 32, 3)
# What the JAX evaluator writes besides eval_metrics.json.
ARTEFACTS = ("spread_field.npy", "spectral_filter.npz", "quantile_map.npz")


def _np(seed, shape, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            out.update({f"{prefix}{k}[{i}]": x for i, x in enumerate(v)})
        else:
            out[f"{prefix}{k}"] = v
    return out


def _disagreements(got: dict, want: dict, keys=None, rtol=RTOL, atol=ATOL) -> list:
    bad = []
    for k in keys or want:
        g, w = got[k], want[k]
        if isinstance(w, (bool, str)) or isinstance(g, (bool, str)):
            if g != w:
                bad.append((k, w, g))
        elif not (math.isfinite(g) and abs(g - w) <= atol + rtol * abs(w)):
            bad.append((k, w, g))
    return bad


def test_metric_keys_are_the_oracle_keys():
    """METRIC_KEYS (the card's check, which never sees runs/) is the key
    set, nesting and order of the committed oracle's eval_metrics.json."""
    oracle = json.loads((ORACLE_DIR / "eval_metrics.json").read_text())
    assert len(oracle) == len(METRIC_KEYS) == 102
    assert list(key_structure(oracle).items()) == list(METRIC_KEYS.items())


@pytest.fixture(scope="module")
def shared():
    """The tiny model's JAX variables (perturbed init) and the port's model
    with the same weights, and the arrays both evaluators' rollouts
    return."""
    jcfg = j_parse_args(["backward-step", *TINY])
    jm = JTMGlow(jcfg.model)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, *HF)),
                         jnp.zeros((1, 4, 8, 3)), j_init_lstm_state(jcfg.model, (1,)))
    v = jax.device_get(v)
    rng = np.random.default_rng(1)
    v = {**v, "params": jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v["params"])}
    tcfg, _ = t_evaluate.parse_args(["backward-step", *TINY])
    tm = TMGlow(tcfg.model, device="cpu")
    tm.load_state_dict(from_flax(v, tm))
    return dict(jm=jm, v=v, tm=tm, base_mean=_np(2, HF, 0.3), base_logvar=_np(3, HF, 0.5),
                fields=_np(4, (N_TRAJ, N, T_CAL, *HF), 0.6))


def _patch_jax(monkeypatch, s):
    monkeypatch.setattr(j_evaluate, "load_eval_bundle", lambda cfg: (s["jm"], s["v"], None, {}))

    def batched(*a, **k):
        def run(variables, lf, keys):  # traced by jax.jit: jnp only
            up = jnp.repeat(jnp.repeat(lf, 4, axis=2), 4, axis=3)
            return {"mean": up + s["base_mean"],
                    "var": 0.05 * jnp.exp(s["base_logvar"]) * (1.0 + up**2)}
        return run

    def members(model, variables, ds, t_cal, n_samples, temperature, overflow_redraw=False):
        return lambda i: (jnp.asarray(ds.denorm_hf(s["fields"][i][:, :t_cal])),
                          jnp.asarray(ds.denorm_hf(ds.hf[i, :t_cal])))

    monkeypatch.setattr(j_evaluate, "make_batched_ensemble_rollout", batched)
    monkeypatch.setattr(j_evaluate, "members_fn_factory", members)


def _patch_port(monkeypatch, s):
    monkeypatch.setattr(t_evaluate, "load_eval_bundle",
                        lambda cfg, device: (s["tm"], None, {}))
    base_mean, base_var = torch.from_numpy(s["base_mean"]), torch.from_numpy(s["base_logvar"])

    def batched(*a, **k):
        def run(lf, generators):
            up = lf.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
            return {"mean": up + base_mean, "var": 0.05 * torch.exp(base_var) * (1.0 + up**2)}
        return run

    def members(model, ds, t_cal, n_samples, temperature, overflow_redraw=False, clock=None):
        return lambda i: (ds.denorm_hf(torch.from_numpy(s["fields"][i][:, :t_cal])),
                          ds.denorm_hf(torch.from_numpy(ds.hf[i, :t_cal].copy())))

    monkeypatch.setattr(t_evaluate, "make_batched_ensemble_rollout", batched)
    monkeypatch.setattr(t_evaluate, "members_fn_factory", members)


def test_evaluator_matches_jax_on_shared_weights_and_samples(shared, monkeypatch, tmp_path):
    _patch_jax(monkeypatch, shared)
    _patch_port(monkeypatch, shared)
    want = j_evaluate.main(["backward-step", *TINY, f"eval.output_dir={tmp_path}/jax"])
    seconds = {}
    got = t_evaluate.main(["backward-step", *TINY, f"eval.output_dir={tmp_path}/port",
                           "--device", "cpu"], seconds)
    assert key_structure(got) == key_structure(want) == METRIC_KEYS
    assert got["backend"] == "cpu" and got["calibration_in_sample"] is False
    saved = json.loads((tmp_path / "port" / "backward-step" / "eval_metrics.json").read_text())
    assert saved == got
    flat_got, flat_want = _flatten(got), _flatten(want)
    keys = [k for k in flat_want if k != "backend"]
    assert not _disagreements(flat_got, flat_want, keys)
    # "calibration rollouts" comes from the real members_fn_factory.
    assert set(seconds) == {"load", "nll", "batched rollout", "reference", "metrics", "figures"}
    # The same files, artefacts in the same formats and values.
    j_dir, t_dir = tmp_path / "jax" / "backward-step", tmp_path / "port" / "backward-step"
    assert sorted(p.name for p in t_dir.iterdir()) == sorted(p.name for p in j_dir.iterdir())
    np.testing.assert_allclose(np.load(t_dir / ARTEFACTS[0]), np.load(j_dir / ARTEFACTS[0]),
                               rtol=RTOL, atol=ATOL)
    for name in ARTEFACTS[1:]:
        with np.load(t_dir / name) as g, np.load(j_dir / name) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert g[k].dtype == w[k].dtype, (name, k)
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL, err_msg=f"{name}:{k}")


def test_evaluate_compute_half_and_cli_guards(shared, monkeypatch, tmp_path):
    """``evaluate()`` writes the metrics and artefacts and draws nothing;
    ``main()`` stops at its start without matplotlib, and with no
    ``--device`` it asks for the GPU."""
    _patch_port(monkeypatch, shared)
    cfg, _ = t_evaluate.parse_args(["backward-step", *TINY, f"eval.output_dir={tmp_path}"])
    metrics, figures = t_evaluate.evaluate(cfg, "cpu")
    out = tmp_path / "backward-step"
    assert sorted(p.name for p in out.iterdir()) == sorted([*ARTEFACTS, "eval_metrics.json"])
    assert [n for n, _ in figures] == ["nll_curve", "energy_spectrum", "reliability",
                                       "fluctuation_pdf", "reliability", "vorticity", "tke"]
    assert key_structure(metrics) == METRIC_KEYS

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    for cli in (t_evaluate, t_rollout):
        with pytest.raises(SystemExit, match="matplotlib is not installed"):
            cli.main(["backward-step", *TINY, "--device", "cpu"])
    monkeypatch.setattr(importlib.util, "find_spec", real)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_evaluate.main(["backward-step", *TINY])


def test_rollout_cli_writes_jax_figures(tmp_path):
    """The rollout CLI's figure files are the JAX CLI's (an untrained init
    on each side: only the names are compared), wrap-tiled horizon."""
    args = ["backward-step", *TINY, "eval.allow_untrained=true", "eval.rollout_steps=8"]
    j_rollout.main([*args, f"eval.output_dir={tmp_path}/jax"])
    t_rollout.main([*args, f"eval.output_dir={tmp_path}/port", "--device", "cpu"])
    names = {d: sorted(p.name for p in (tmp_path / d / "backward-step").iterdir())
             for d in ("jax", "port")}
    assert names["port"] == names["jax"]
    assert {"pred_t0000_u.png", "pred_t0003_u.png", "pred_t0005_u.png", "tke.png",
            "profiles_u.png", "probes_u.png", "vorticity_t0005.png",
            "samples_t0003_u.png"} <= set(names["port"])


def _exporter():
    spec = importlib.util.spec_from_file_location("export_to_torch",
                                                  ROOT / "tools" / "export_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_gap():
    sys.path.insert(0, str(ROOT / "tools"))
    import bf16_gap

    return bf16_gap


def _arrays(path) -> dict:
    """The arrays of an ``.npy`` ("") or ``.npz`` file, by name."""
    data = np.load(path)
    if isinstance(data, np.ndarray):
        return {"": data}
    with data:
        return {k: data[k] for k in data.files}


def test_committed_oracle_through_the_exporter(tmp_path):
    """The oracle's checkpoint, exported, evaluated by the port with the
    oracle's overrides (eval.n_samples 4, rollout_steps 8,
    calibration_steps 6, ref_steps 16, traj_batch 2) at bf16."""
    _exporter().export(ORACLE_CASE, ORACLE_CKPT, tmp_path / "ckpt")
    over = [o for o in ORACLE_OVERRIDES if not o.startswith("train.checkpoint_dir=")]
    assert len(over) == len(ORACLE_OVERRIDES) - 1
    got = t_evaluate.main([ORACLE_CASE, *over, f"train.checkpoint_dir={tmp_path}/ckpt",
                           f"eval.output_dir={tmp_path}/eval", "--device", "cpu"])
    want = json.loads((ORACLE_DIR / "eval_metrics.json").read_text())
    assert list(key_structure(got).items()) == list(key_structure(want).items())
    assert got["backend"] == "cpu" == want["backend"]
    # The numbers that no ensemble draw enters.
    sample_free = [k for k in want if k.startswith("baseline_")] + [
        "divergence_rms_ref", "n_test_traj", "steps", "ref_steps", "n_samples",
        "calibration_steps", "deployed_spread_scale", "calibration_semantics"]
    assert len(sample_free) == 19
    assert not _disagreements(got, want, sample_free)
    assert all(math.isfinite(v) for v in _flatten(got).values() if isinstance(v, float))
    # The figures and artefacts are the oracle's files.
    assert (sorted(p.name for p in (tmp_path / "eval" / ORACLE_CASE).iterdir())
            == sorted(p.name for p in ORACLE_DIR.iterdir()))

    # test_bpd: the port's fused numerics against the oracle's default bf16
    # path, within JAX's own gap between the two (measured here) + 1e-3.
    bpds = _bf16_gap().jax_bpds(ORACLE_CKPT, want["steps"], fused=True).mean(axis=1)
    for key, fused in (("test_bpd", float(np.mean(bpds))), ("test_bpd_last_step", float(bpds[-1]))):
        jax_gap = abs(fused - want[key])
        assert abs(got[key] - want[key]) <= jax_gap + BF16_TOL * abs(want[key]), key

    # The port's committed oracle, regenerated by make_eval_oracle: bit for bit.
    assert over == [o for o in t_make_eval_oracle.ORACLE_OVERRIDES
                    if not o.startswith("train.checkpoint_dir=")]
    assert json.loads(json.dumps(got)) == json.loads(
        (PORT_ORACLE_DIR / "eval_metrics.json").read_text())
    assert (sorted(p.name for p in PORT_ORACLE_DIR.iterdir())
            == sorted(p.name for p in ORACLE_DIR.iterdir()))
    for name in ARTEFACTS:
        a, b = _arrays(tmp_path / "eval" / ORACLE_CASE / name), _arrays(PORT_ORACLE_DIR / name)
        assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a), name
