"""The port's ``eval/calibrate.py`` and the metric stages of
``eval/metrics.py`` against the JAX package's, on the same NumPy arrays.

Functions: 1e-5 relative, 1e-6 absolute near 0, as ``test_torch_stats.py``.
Stages (``per_trajectory_metrics``, ``shape_metrics_traj0``,
``fit_calibration_artifacts``, ``score_holdout``,
``calibration_metric_rows``): both sides get the same normalized rollout
stats and the same member fields; every number they return, the saved
``spread_field.npy`` / ``spectral_filter.npz`` / ``quantile_map.npz`` and
the figure payloads (JAX's plot calls recorded) agree to 1e-4 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.eval.calibrate as jc
import tpuflow.eval.metrics as jmet
import tpuflow_torch.eval.calibrate as tc
import tpuflow_torch.eval.metrics as tmet
from tpuflow.configs.config import load_case as j_load_case
from tpuflow.data.dataset import load_dataset as j_load_dataset
from tpuflow_torch.configs import load_case
from tpuflow_torch.data import load_dataset

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
STAGE_RTOL, STAGE_ATOL = 1e-4, 1e-6


def _np(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


MEMBERS = [(4, 3, 8, 16, 3), (6, 2, 16, 32, 3)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", MEMBERS)
def test_spread_and_variance_fits(shape, axis):
    x = _np(0, shape, 0.5)
    ref = _np(1, shape[1:], 1.5)
    if axis == 1:
        x = np.moveaxis(x, 0, 1).copy()
    (jx, tx), (jr, tr) = _both(x), _both(ref)
    _close(tc.ensemble_zscores(tx, tr, axis), jc.ensemble_zscores(jx, jr, axis))
    _close(tc.fit_spread_scale(tx, tr, axis), jc.fit_spread_scale(jx, jr, axis))
    _close(tc.fit_variance_scale(tx, tr, axis), jc.fit_variance_scale(jx, jr, axis))
    for levels in ((0.5, 0.8, 0.9, 0.95), (0.3, 0.99)):
        _close(tc.fit_interval_scales(tx, tr, levels, axis),
               jc.fit_interval_scales(jx, jr, levels, axis))
    z = tc.ensemble_zscores(tx, tr, axis)
    jz = jc.ensemble_zscores(jx, jr, axis)
    for prior, clip in ((8.0, (0.25, 6.0)), (0.0, (0.1, 2.0))):
        _close(tc.fit_spread_field_from_z(z, prior, clip),
               jc.fit_spread_field_from_z(jz, prior, clip))


@pytest.mark.parametrize("r2,v,n", [(0.3, 0.1, 4), (0.01, 0.5, 4), (1.0, 1.0, 64), (2.0, 0.0, 2)])
def test_variance_scale_from_moments(r2, v, n):
    """Includes the floor at 0 (residuals under the ensemble-mean noise)."""
    _close(tc.fit_variance_scale_from_moments(r2, v, n),
           jc.fit_variance_scale_from_moments(r2, v, n))


def test_fits_need_two_members():
    with pytest.raises(ValueError, match=">= 2 members"):
        tc.ensemble_zscores(torch.zeros(1, 3), torch.zeros(3))
    with pytest.raises(ValueError, match=">= 2 members"):
        tc.fit_variance_scale_from_moments(0.1, 0.1, 1)


@pytest.mark.parametrize("scale", [1.7, "field"])
def test_scale_members(scale):
    x = _np(2, MEMBERS[0])
    jx, tx = _both(x)
    if scale == "field":
        s = _np(3, MEMBERS[0][2:], 0.3, 2.0)
        _close(tc.scale_members(tx, torch.from_numpy(s)), jc.scale_members(jx, jnp.asarray(s)))
    else:
        _close(tc.scale_members(tx, scale), jc.scale_members(jx, scale))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_quantiles", [16, 65])
def test_quantile_map(n_quantiles, ties):
    """Fit and apply, values beyond the knots (linear tails) included;
    ``ties`` puts a constant region in the marginal (strictly increasing
    knots by the ramp and running maximum)."""
    pred, ref = _np(4, (2000,), 1.3, 0.2), _np(5, (1500,), 0.8)
    if ties:
        pred[:900] = 0.0
    xq, yq = jc.fit_quantile_map(jnp.asarray(pred), jnp.asarray(ref), n_quantiles)
    txq, tyq = tc.fit_quantile_map(torch.from_numpy(pred), torch.from_numpy(ref), n_quantiles)
    _close(txq, xq)
    _close(tyq, yq)
    assert (txq[1:] > txq[:-1]).all()
    vals = _np(6, (3, 40), 3.0)
    _close(tc.apply_quantile_map(torch.from_numpy(vals), txq, tyq),
           jc.apply_quantile_map(jnp.asarray(vals), xq, yq), atol=1e-5)


@pytest.mark.parametrize("n_quantiles", [16, 65])
def test_stratified_quantile_map(n_quantiles):
    pred, ref = _np(7, (12, 300), 1.2), _np(8, (12, 200), 0.9, 0.1)
    pred[3] = 0.5  # a constant stratum
    xq, yq = jc.fit_quantile_map_stratified(jnp.asarray(pred), jnp.asarray(ref), n_quantiles)
    txq, tyq = tc.fit_quantile_map_stratified(torch.from_numpy(pred), torch.from_numpy(ref),
                                              n_quantiles)
    _close(txq, xq)
    _close(tyq, yq)
    vals = _np(9, (12, 5, 7), 2.5)
    _close(tc.apply_quantile_map_stratified(torch.from_numpy(vals), txq, tyq),
           jc.apply_quantile_map_stratified(jnp.asarray(vals), xq, yq), atol=1e-5)


def test_lf_conditioned_quantile_map():
    preds = [_np(10 + i, (4, 3, 8, 16), 0.5 + i) for i in range(3)]
    refs = [_np(20 + i, (6, 8, 16), 1.0 + 0.3 * i) for i in range(3)]
    lf_stds = [0.4, 0.9, 1.3]
    xq, yq, alpha = jc.fit_lf_conditioned_qmap(preds, refs, lf_stds)
    txq, tyq, talpha = tc.fit_lf_conditioned_qmap([torch.from_numpy(p) for p in preds],
                                                  [torch.from_numpy(r) for r in refs], lf_stds)
    _close(txq, xq)
    _close(tyq, yq)
    assert talpha == pytest.approx(alpha, rel=RTOL)
    vals = _np(30, (4, 3, 8, 16), 2.0)
    _close(tc.apply_lf_conditioned_qmap(torch.from_numpy(vals), 1.1, 0.7, txq, tyq, talpha),
           jc.apply_lf_conditioned_qmap(jnp.asarray(vals), 1.1, 0.7, xq, yq, alpha), atol=1e-5)


@pytest.mark.parametrize("domain", [(1.0, 4.0), (1.0, 1.0)])
@pytest.mark.parametrize("cap", [1.2, 3.0])
def test_spectral_filter(domain, cap):
    import tpuflow.eval.stats as js
    import tpuflow_torch.eval.stats as ts

    m, ref = _np(40, (4, 3, 16, 32, 3)), _np(41, (5, 16, 32, 3), 0.6)
    jk, je = js.energy_spectrum(jnp.asarray(m[..., :2]), domain, taper=True)
    _, jr = js.energy_spectrum(jnp.asarray(ref[..., :2]), domain, taper=True)
    tk, te = ts.energy_spectrum(torch.from_numpy(m[..., :2]), domain, taper=True)
    _, tr = ts.energy_spectrum(torch.from_numpy(ref[..., :2]), domain, taper=True)
    jf = jc.fit_spectral_filter(je, jr, jk, cap)
    tf = tc.fit_spectral_filter(te, tr, tk, cap)
    _close(tf[0], jf[0])
    _close(tf[1], jf[1])
    _close(tc.apply_spectral_filter(torch.from_numpy(m), *tf, domain),
           jc.apply_spectral_filter(jnp.asarray(m), *jf, domain), atol=1e-5)


@pytest.mark.parametrize("scales", [[1.0, 1.0, 1.0, 1.0], [1.5, 2.0, 2.5, 3.0]])
def test_scaled_interval_coverage(scales):
    mean, var, ref = _np(50, (3, 8, 16)), _np(51, (3, 8, 16)) ** 2, _np(52, (3, 8, 16), 2.0)
    (jm, tm), (jv, tv), (jr, tr) = _both(mean), _both(var), _both(ref)
    _close(tc.scaled_interval_coverage(tm, tv, tr, torch.tensor(scales)),
           jc.scaled_interval_coverage(jm, jv, jr, jnp.asarray(scales)))
    z = _np(53, (200,))
    _close(tc.fit_interval_scales_from_z(torch.from_numpy(z)),
           jc.fit_interval_scales_from_z(jnp.asarray(z)))
    _close(tc.fit_spread_scale_from_z(torch.from_numpy(z)),
           jc.fit_spread_scale_from_z(jnp.asarray(z)))


# --- the metric stages -----------------------------------------------------

STAGE_ARGS = {
    "model.hf_shape": "16,32", "model.lf_shape": "4,8", "model.n_scales": "2",
    "data.n_test_traj": "3", "data.n_train_traj": "2", "data.train_steps": "6",
    "eval.n_samples": "4", "eval.ref_steps": "12", "eval.calibration_steps": "5",
}
T, T_CAL, N = 6, 5, 4


@pytest.fixture(scope="module")
def stage_inputs():
    """Both packages' configs and test splits of the same fixture, normalized
    rollout stats, member fields of every trajectory and the long
    reference."""
    jcfg, cfg = j_load_case("backward-step", STAGE_ARGS), load_case("backward-step", STAGE_ARGS)
    jds = j_load_dataset(jcfg.data, jcfg.model, "test")
    ds = load_dataset(cfg.data, cfg.model, "test")
    np.testing.assert_array_equal(ds.hf, jds.hf)
    shape = (ds.n_traj, T, 16, 32, 3)
    means = ds.hf[:, :T] + _np(60, shape, 0.2)
    vars_ = _np(61, shape, 0.3, 0.4) ** 2
    fields = [ds.hf[i, :T_CAL][None] + _np(70 + i, (N, T_CAL, 16, 32, 3), 0.5)
              for i in range(ds.n_traj)]
    hf_long, ref_steps = jmet.long_reference(jcfg, jds, T)
    t_long, t_ref_steps = tmet.long_reference(cfg, ds, T)
    assert ref_steps == t_ref_steps == 12
    np.testing.assert_array_equal(t_long, hf_long)
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, means=means, vars_=vars_, fields=fields,
                hf_long=hf_long)


def _members_fns(s):
    def j_fn(i):
        return (jnp.asarray(s["jds"].denorm_hf(s["fields"][i])),
                jnp.asarray(s["jds"].denorm_hf(s["jds"].hf[i, :T_CAL])))

    def t_fn(i):
        return (s["ds"].denorm_hf(torch.from_numpy(s["fields"][i])),
                s["ds"].denorm_hf(torch.from_numpy(s["ds"].hf[i, :T_CAL])))
    return j_fn, t_fn


def _same(got, want, path="", rtol=STAGE_RTOL):
    """Every number of two nested results agrees (tensors and arrays
    elementwise)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}", rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]", rtol)
    elif isinstance(want, (str, bool)) or want is None:
        assert got == want, path
    else:
        g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=STAGE_ATOL, err_msg=path)


def test_per_trajectory_metrics(stage_inputs):
    s = stage_inputs
    want = jmet.per_trajectory_metrics(s["jcfg"], s["jds"], s["means"], s["vars_"],
                                       s["hf_long"], T)
    got = tmet.per_trajectory_metrics(s["cfg"], s["ds"], torch.from_numpy(s["means"]),
                                      torch.from_numpy(s["vars_"]), s["hf_long"], T)
    _same(got, want)
    # Without the long reference, the rollout horizon's frames.
    want = jmet.per_trajectory_metrics(s["jcfg"], s["jds"], s["means"], s["vars_"], None, T)
    got = tmet.per_trajectory_metrics(s["cfg"], s["ds"], torch.from_numpy(s["means"]),
                                      torch.from_numpy(s["vars_"]), None, T)
    _same(got, want)


def _record_plots(monkeypatch, module):
    calls = []
    for name in ("plot_energy_spectrum", "plot_fluctuation_pdf", "plot_reliability"):
        monkeypatch.setattr(module, name, lambda out_dir, *a, _n=name, **k:
                            calls.append((_n.removeprefix("plot_"), a, k)))
    return calls


def test_shape_metrics_traj0(stage_inputs, monkeypatch, tmp_path):
    """The calib dict, and the payloads against the arguments of JAX's plot
    calls (histogram densities on the same shared range)."""
    s = stage_inputs
    calls = _record_plots(monkeypatch, jmet)
    j_fn, t_fn = _members_fns(s)
    want = jmet.shape_metrics_traj0(s["jcfg"], s["jds"], *j_fn(0), s["hf_long"], T_CAL, tmp_path)
    got, figures = tmet.shape_metrics_traj0(s["cfg"], s["ds"], *t_fn(0), s["hf_long"], T_CAL)
    _same(got, want)
    assert [n for n, _ in figures] == [n for n, _, _ in calls]
    for (_, kw), (_, args, _) in zip(figures, calls):
        _same(list(kw.values()), list(args))
    # No long reference: the t_cal window.
    want = jmet.shape_metrics_traj0(s["jcfg"], s["jds"], *j_fn(0), None, T_CAL, tmp_path)
    got, _ = tmet.shape_metrics_traj0(s["cfg"], s["ds"], *t_fn(0), None, T_CAL)
    _same(got, want)


def _fit_both(s, tmp_path, fit_idx):
    j_fn, t_fn = _members_fns(s)
    (tmp_path / "j").mkdir(exist_ok=True)
    (tmp_path / "t").mkdir(exist_ok=True)
    jfits = jmet.fit_calibration_artifacts(s["jcfg"], s["jds"], *j_fn(0), j_fn, s["hf_long"],
                                           fit_idx, tmp_path / "j")
    tfits = tmet.fit_calibration_artifacts(s["cfg"], s["ds"], *t_fn(0), t_fn, s["hf_long"],
                                           fit_idx, tmp_path / "t")
    return jfits, tfits, j_fn, t_fn


@pytest.mark.parametrize("fit_idx", [[0, 2], [0]])
def test_fit_calibration_artifacts(stage_inputs, tmp_path, fit_idx):
    """The fitted objects and the three files, in the same formats."""
    jfits, tfits, _, _ = _fit_both(stage_inputs, tmp_path, fit_idx)
    _same(tfits, jfits)
    _same(np.load(tmp_path / "t" / "spread_field.npy"),
          np.load(tmp_path / "j" / "spread_field.npy"))
    for name in ("spectral_filter.npz", "quantile_map.npz"):
        with np.load(tmp_path / "t" / name) as got, np.load(tmp_path / "j" / name) as want:
            assert set(got.files) == set(want.files), name
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (name, k)
                np.testing.assert_allclose(got[k], want[k], rtol=STAGE_RTOL, atol=STAGE_ATOL,
                                           err_msg=f"{name}:{k}")


@pytest.mark.parametrize("report_idx,hold_idx", [([1], [1]), ([0], [])])
def test_score_holdout_and_rows(stage_inputs, tmp_path, report_idx, hold_idx):
    """Holdout scoring and the metric rows: the disjoint split, and the
    one-trajectory fallback (scored in sample, flagged)."""
    s = stage_inputs
    jfits, tfits, j_fn, t_fn = _fit_both(s, tmp_path, [0, 2])
    want = jmet.score_holdout(s["jcfg"], s["jds"], *j_fn(0), j_fn, s["hf_long"], report_idx,
                              jfits, T_CAL)
    got = tmet.score_holdout(s["cfg"], s["ds"], *t_fn(0), t_fn, s["hf_long"], report_idx,
                             tfits, T_CAL)
    _same(got, want)
    rows = tmet.calibration_metric_rows(tfits, got, hold_idx)
    _same(rows, jmet.calibration_metric_rows(jfits, want, hold_idx))
    assert list(rows) == list(jmet.calibration_metric_rows(jfits, want, hold_idx))
    assert rows["calibration_in_sample"] is (not hold_idx)


def test_stage_configs_agree():
    """The evaluator's config fields read by the stages have JAX's
    defaults."""
    from tpuflow.configs.config import DataConfig as JData
    from tpuflow.configs.config import EvalConfig as JEval
    from tpuflow_torch.configs.config import DataConfig, EvalConfig

    jeval = dataclasses.asdict(JEval())
    assert dataclasses.asdict(EvalConfig()) == jeval
    for k in ("domain_x", "domain_y", "seed", "fixture_version"):
        assert getattr(DataConfig(), k) == getattr(JData(), k)
