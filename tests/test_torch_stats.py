"""The port's ``eval/stats.py`` and ``eval/baseline.py`` against the JAX
package's, function by function, on the same NumPy arrays (float32).

Tolerance: 1e-5 relative, 1e-6 absolute near 0 (both sides compute the
same float32 expressions; reductions, FFTs and the special functions
differ in summation order and in the last bits). Histogram counts must
match exactly, values that fall on bin edges included. The quantile,
written by hand because ``torch.quantile`` refuses more than 2^24 values,
is also held above that size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.eval.baseline as jb
import tpuflow.eval.stats as js
import tpuflow_torch.eval.baseline as tb
import tpuflow_torch.eval.stats as ts

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(4, 3, 8, 16, 3), (5, 2, 16, 32, 3)]  # (N, T, H, W, C)


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


@pytest.mark.parametrize("shape", SHAPES)
def test_pointwise_statistics(shape):
    x = _np(0, shape, 2.0, 0.5)
    ref = _np(1, shape[1:], 2.0)
    jx, tx = _both(x)
    jr, tr = _both(ref)
    _close(ts.tke_field(tx[0]), js.tke_field(jx[0]))
    for k in ("mean", "var"):
        _close(ts.ensemble_stats(tx)[k], js.ensemble_stats(jx)[k])
    for axes in ((0,), (0, 1)):
        jm, tm = js.velocity_moments(jx, axes), ts.velocity_moments(tx, axes)
        for k in ("mean", "var", "skew", "kurt"):
            _close(tm[k], jm[k])
        _close(ts.reynolds_stress_uv(tx, axes), js.reynolds_stress_uv(jx, axes))
    _close(ts.relative_l2(tx[0], tr), js.relative_l2(jx[0], jr))
    _close(ts.relative_l2(tx[0], tr, axes=(1, 2)), js.relative_l2(jx[0], jr, axes=(1, 2)))
    _close(ts.total_variance(tx[0], tx[1] ** 2), js.total_variance(jx[0], jx[1] ** 2))


@pytest.mark.parametrize("spacing", [(1.0, 1.0), (4.0 / 128, 1.0 / 64)])
@pytest.mark.parametrize("shape", SHAPES)
def test_vorticity_and_divergence(shape, spacing):
    jx, tx = _both(_np(2, shape))
    dx, dy = spacing
    _close(ts.vorticity(tx, dx, dy), js.vorticity(jx, dx, dy), atol=1e-4 * max(1 / dx, 1 / dy))
    _close(ts.divergence(tx, dx, dy), js.divergence(jx, dx, dy),
           atol=1e-4 * max(1 / dx, 1 / dy))


def test_degenerate_moments_are_zero_not_nan():
    x = np.zeros((4, 3, 8, 16, 3), np.float32)
    tm = ts.velocity_moments(torch.from_numpy(x), (0, 1))
    jm = js.velocity_moments(jnp.asarray(x), (0, 1))
    for k in ("skew", "kurt"):
        _close(tm[k], jm[k])
        assert torch.isfinite(tm[k]).all()


@pytest.mark.parametrize("taper", [False, True])
@pytest.mark.parametrize("domain", [None, (1.0, 4.0), (2.0, 1.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_energy_spectrum(shape, domain, taper):
    x = _np(3, shape)[..., :2]
    x = x - x.mean(axis=(0, 1), keepdims=True)
    jk, je = js.energy_spectrum(jnp.asarray(x), domain, taper)
    tk, te = ts.energy_spectrum(torch.from_numpy(x), domain, taper)
    _close(tk, jk, rtol=0, atol=0)
    _close(te, je)


@pytest.mark.parametrize("bounds", [(None, None), (-1.0, 1.5), (-4.0, 4.0)])
@pytest.mark.parametrize("bins", [16, 64])
def test_fluctuation_pdf(bins, bounds):
    x = _np(4, (3, 4, 8, 16))
    lo, hi = bounds
    jc, jd = js.fluctuation_pdf(jnp.asarray(x), bins, lo, hi)
    tc, td = ts.fluctuation_pdf(torch.from_numpy(x), bins, lo, hi)
    _close(tc, jc)
    _close(td, jd)


@pytest.mark.parametrize("value", [0.0, 2.5, -3.0])
def test_fluctuation_pdf_of_constant_samples(value):
    """A zero-width range widens by JAX's guard; the densities equal JAX's,
    NaN included where that narrow range's float32 bins collapse."""
    x = np.full((5, 7), value, np.float32)
    jc, jd = js.fluctuation_pdf(jnp.asarray(x))
    tc, td = ts.fluctuation_pdf(torch.from_numpy(x))
    _close(tc, jc)
    _close(td, jd)


@pytest.mark.parametrize("bins,lo,hi", [(8, -1.0, 1.0), (10, 0.0, 1.0), (64, -2.5, 3.25)])
def test_histogram_counts_exact_with_values_on_edges(bins, lo, hi):
    """Counts equal jnp.histogram's exactly, values on every f32 edge, the
    range's ends and outside it included (the last bin is closed on the
    right; values outside are dropped)."""
    _, edges = jnp.histogram(jnp.zeros(1), bins=bins, range=(lo, hi))
    x = np.concatenate([np.asarray(edges), _np(5, (500,), 1.5),
                        np.float32([lo - 1, hi + 1, lo, hi])]).astype(np.float32)
    jcounts, jedges = jnp.histogram(jnp.asarray(x), bins=bins, range=(lo, hi))
    td, tedges, tcounts = ts.histogram(torch.from_numpy(x), bins, lo, hi)
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))
    jd, _ = jnp.histogram(jnp.asarray(x), bins=bins, range=(lo, hi), density=True)
    _close(td, jd)


@pytest.mark.parametrize("q", [0.5, [0.0, 0.1, 0.5, 0.97, 1.0]])
@pytest.mark.parametrize("dim", [None, 0, 1])
def test_quantile(q, dim):
    x = _np(6, (7, 9, 5))
    _close(ts.quantile(torch.from_numpy(x), q, dim=dim),
           jnp.quantile(jnp.asarray(x), jnp.asarray(q, jnp.float32), axis=dim))


def test_quantile_nan_propagates():
    x = _np(7, (4, 6))
    x[2, 3] = np.nan
    got = ts.quantile(torch.from_numpy(x), [0.25, 0.75], dim=1)
    want = jnp.quantile(jnp.asarray(x), jnp.asarray([0.25, 0.75]), axis=1)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))


def test_quantile_above_two_to_the_24_values():
    """2^24 + 3 values: torch.quantile refuses them; the port's quantile
    and wasserstein1 equal JAX's (whose n - 1 in float32 is inexact here)."""
    n = 2**24 + 3
    x = np.random.default_rng(8).standard_normal(n, dtype=np.float32)
    tx = torch.from_numpy(x)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(tx, 0.5)
    q = np.float32([0.0, 1e-7, 0.25, 0.5, 0.9, 1.0])
    _close(ts.quantile(tx, q), jnp.quantile(jnp.asarray(x), jnp.asarray(q)))
    b = _np(9, (1000,), 1.2, 0.1)
    _close(ts.wasserstein1(tx, torch.from_numpy(b)),
           js.wasserstein1(jnp.asarray(x), jnp.asarray(b)))


@pytest.mark.parametrize("n_quantiles", [16, 256])
@pytest.mark.parametrize("shape", SHAPES)
def test_wasserstein1(shape, n_quantiles):
    a, b = _np(10, shape), _np(11, shape[1:], 1.3, 0.2)
    _close(ts.wasserstein1(torch.from_numpy(a), torch.from_numpy(b), n_quantiles),
           js.wasserstein1(jnp.asarray(a), jnp.asarray(b), n_quantiles))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_ensemble_crps_and_coverage(shape, axis):
    x = _np(12, shape)
    ref = _np(13, shape[1:], 1.5)
    if axis == 1:
        x = np.moveaxis(x, 0, 1).copy()
    jx, tx = _both(x)
    jr, tr = _both(ref)
    _close(ts.ensemble_crps(tx, tr, axis), js.ensemble_crps(jx, jr, axis))
    for levels in ((0.5, 0.8, 0.9, 0.95), (0.3,)):
        _close(ts.ensemble_coverage(tx, tr, levels, axis),
               js.ensemble_coverage(jx, jr, levels, axis))


def test_ensemble_crps_needs_two_members():
    with pytest.raises(ValueError, match=">= 2 members"):
        ts.ensemble_crps(torch.zeros(1, 3), torch.zeros(3))


@pytest.mark.parametrize("scales", [None, [1.2, 1.5, 2.0, 3.0]])
@pytest.mark.parametrize("levels", [(0.5, 0.8, 0.9, 0.95), (0.6, 0.99)])
def test_gaussian_scores(levels, scales):
    if scales is not None and len(scales) != len(levels):
        with pytest.raises(ValueError, match="scales for"):
            ts.gaussian_coverage(torch.zeros(3), torch.ones(3), torch.zeros(3), levels, scales)
        return
    mean, var, ref = _np(14, (3, 8, 16)), _np(15, (3, 8, 16)) ** 2, _np(16, (3, 8, 16), 2.0)
    (jm, tm), (jv, tv), (jr, tr) = _both(mean), _both(var), _both(ref)
    _close(ts.gaussian_crps(tm, tv, tr), js.gaussian_crps(jm, jv, jr))
    _close(ts.gaussian_coverage(tm, tv, tr, levels, scales),
           js.gaussian_coverage(jm, jv, jr, levels, scales))
    _close(ts.interval_z(list(levels)), js.interval_z(jnp.asarray(levels)))


@pytest.mark.parametrize("lf_shape,hf_shape", [((16, 32), (64, 128)), ((24, 24), (96, 96)),
                                               ((4, 8), (16, 32)), ((16, 32), (16, 32))])
def test_lf_upsample_matches_jax_cubic_resize(lf_shape, hf_shape):
    """jax.image.resize "cubic" (Keys a = -0.5, border weights
    renormalized), the preset's 16x32 -> 64x128 first."""
    x = _np(17, (3, *lf_shape, 3), 2.0, 1.0)
    _close(tb.lf_upsample(torch.from_numpy(x), hf_shape),
           jb.lf_upsample(jnp.asarray(x), hf_shape), atol=1e-5)
    assert tb.skill(0.5, 1.0) == jb.skill(0.5, 1.0)
