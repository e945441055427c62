"""Parity of the port's models and rollout (tpuflow_torch.models,
tpuflow_torch.eval) with the JAX package on the same weights, inputs and
latent draws, at a small size (2 scales x 2 steps, width 16).

JAX weights come from ``TMGlow(...).init`` (perturbed, so the zero-init
coupling heads and priors compute something) and cross through
``tpuflow_torch.convert.from_flax``. The JAX PRNG cannot be reproduced
in torch, so the tests draw JAX's latents exactly as its rollout does --
``split(key)`` per step, ``split(rng, L)`` per scale, then
``normal(rng_l, mean.shape)`` -- and hand them to the port as ``eps``.
Both sides compute at float32; tolerances are float32 ones, loosened
where the reverse flow amplifies summation-order differences over
2 scales x 2 steps x 4 timesteps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.configs.config import ModelConfig as JModelConfig
from tpuflow.eval.rollout import make_ensemble_rollout as j_make_ensemble_rollout
from tpuflow.models import TMGlow as JTMGlow
from tpuflow.models import init_lstm_state as j_init_lstm_state
from tpuflow.models.tmglow import build_inv_caches as j_build_inv_caches
from tpuflow_torch.configs import ModelConfig, load_case
from tpuflow_torch.convert import from_flax
from tpuflow_torch.eval import make_ensemble_rollout
from tpuflow_torch.models import TMGlow, init_lstm_state, scale_shapes

torch.set_num_threads(1)

SMALL = dict(
    n_scales=2, n_flow_steps=2, channels=3, hf_shape=(16, 32), lf_shape=(4, 8),
    coupling_width=16, coupling_layers=2, growth_rate=8, encoder_width=8,
    lstm_hidden=8, cond_channels=8, compute_dtype="float32", z_clip=4.0,
)
N, T, TAU = 4, 4, 0.85


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its perturbed variables, the port's model on the CPU
    with the same weights)."""
    jm = JTMGlow(JModelConfig(conv_layout="nhwc", **SMALL))
    state = j_init_lstm_state(jm.cfg, (2,))
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_np(1, (2, 16, 32, 3))),
                jnp.asarray(_np(2, (2, 4, 8, 3))), state)
    v = jax.device_get(v)
    rng = np.random.default_rng(3)
    v = {**v, "params": jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v["params"])}
    tm = TMGlow(ModelConfig(**SMALL), device="cpu")
    tm.load_state_dict(from_flax(v, tm))
    return jm, v, tm


def _latent_shapes(cfg, n):
    """Shape of each scale's standard-normal draw: the factored half at
    the splits, the whole latent at the base prior."""
    shapes, c = [], cfg.channels
    for l, (h, w) in enumerate(scale_shapes(cfg)):
        c *= 4
        if l < cfg.n_scales - 1:
            shapes.append((n, h, w, c // 2))
            c //= 2
        else:
            shapes.append((n, h, w, c))
    return shapes


def _jax_step_eps(sub, cfg, n):
    """The draws glow.reverse makes from one step key."""
    keys = jax.random.split(sub, cfg.n_scales)
    return [np.asarray(jax.random.normal(k, s, jnp.float32))
            for k, s in zip(keys, _latent_shapes(cfg, n))]


def _jax_rollout_eps(key, cfg, n, steps):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append([torch.tensor(e) for e in _jax_step_eps(sub, cfg, n)])
    return out


def test_load_case_overrides_and_layout_fields():
    cfg = load_case("backward-step")
    assert cfg.model.hf_shape == (64, 128) and cfg.model.coupling_width == 64
    assert cfg.model.compute_dtype == "bfloat16" and cfg.eval.temperature == 0.85
    small = load_case("backward-step", {"model.n_scales": "2", "model.hf_shape": "16,32",
                                        "model.flow_layout": "hwnc"})
    assert small.model.n_scales == 2 and small.model.hf_shape == (16, 32)
    with pytest.raises(KeyError):
        load_case("backward-step", {"model.no_such_field": 1})
    with pytest.raises(ValueError):
        load_case("backward-step", {"model.hf_shape": "12,32"})


def test_encoder_lstm_and_conditioning(pair):
    jm, v, tm = pair
    lf = _np(4, (T, 4, 8, 3))
    feats_j = jm.apply(v, jnp.asarray(lf), method=JTMGlow.encode_lf)
    with torch.no_grad():
        feats_t = tm.encode_lf(torch.tensor(lf))
    for fj, ft in zip(feats_j, feats_t):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5, rtol=1e-5)
    # One step of the recurrence, batch-1 features against N members.
    state_np = [(_np(5 + l, (N, h, w, 8), 0.5), _np(7 + l, (N, h, w, 8), 0.5))
                for l, (h, w) in enumerate(scale_shapes(tm.cfg))]
    state_j = tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in state_np)
    state_t = tuple((torch.tensor(h), torch.tensor(c)) for h, c in state_np)

    def cond_j(mdl, feats, state):
        conds, new = [], []
        for l in range(mdl.cfg.n_scales):
            f = feats[l][None]
            h, s = mdl.cells[l](f, state[l])
            conds.append(mdl.cond_proj_f[l](f) + mdl.cond_proj_h[l](h))
            new.append(s)
        return conds, new

    conds_j, new_j = jm.apply(v, [f[0] for f in feats_j], state_j, method=cond_j)
    with torch.no_grad():
        conds_t, new_t = tm.condition([f[0] for f in feats_t], state_t)
    for cj, ct in zip(conds_j, conds_t):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=1e-5)
    for (hj, cj), (ht, ct) in zip(new_j, new_t):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=1e-5)


def test_glow_forward_reverse_roundtrip(pair):
    jm, v, tm = pair
    x = _np(9, (2, 16, 32, 3))
    conds = [_np(10 + l, (2, h, w, 8)) for l, (h, w) in enumerate(scale_shapes(tm.cfg))]
    lat_j, ld_j, lp_j = jm.apply(
        v, jnp.asarray(x), [jnp.asarray(c) for c in conds],
        method=lambda m, x, c: m.glow.forward(x, c))
    with torch.no_grad():
        conds_t = [torch.tensor(c) for c in conds]
        lat_t, ld_t, lp_t = tm.glow(torch.tensor(x), conds_t)
        x_rec, lp_rec = tm.glow.reverse(conds_t, latents=lat_t)
    for a, b in zip(lat_t, lat_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=1e-2, rtol=1e-5)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-2, rtol=1e-5)
    # The BASELINE invertibility gate at f32.
    np.testing.assert_allclose(x_rec.numpy(), x, atol=1e-4, rtol=0)
    np.testing.assert_allclose(lp_rec.numpy(), lp_t.numpy(), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("tau", [TAU, (0.7, 0.9)])
def test_sample_from_feats_matches_jax(pair, tau):
    jm, v, tm = pair
    feats = [_np(12 + l, (h, w, 8)) for l, (h, w) in enumerate(scale_shapes(tm.cfg))]
    state_np = [(_np(14 + l, (N, h, w, 8), 0.5), _np(16 + l, (N, h, w, 8), 0.5))
                for l, (h, w) in enumerate(scale_shapes(tm.cfg))]
    rng = jax.random.PRNGKey(18)
    tau_j = tau if isinstance(tau, float) else jnp.asarray(tau)
    x_j, s_j = jm.apply(
        v, [jnp.asarray(f) for f in feats],
        tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in state_np),
        rng, tau_j, j_build_inv_caches(jm.cfg, v), method=JTMGlow.sample_from_feats)
    eps = [torch.tensor(e) for e in _jax_step_eps(rng, tm.cfg, N)]
    with torch.no_grad():
        x_t, s_t = tm.sample_from_feats(
            [torch.tensor(f) for f in feats],
            tuple((torch.tensor(h), torch.tensor(c)) for h, c in state_np),
            temperature=tau if isinstance(tau, float) else torch.tensor(tau),
            eps=eps, inv_caches=tm.build_inv_caches(), packs=tm.glow.pack_couplings())
    assert x_t.shape == (N, 16, 32, 3)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-4, rtol=1e-4)
    for (hj, cj), (ht, ct) in zip(s_j, s_t):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("collect", ["stats", "fields"])
def test_rollout_matches_jax(pair, collect):
    jm, v, tm = pair
    lf = _np(19, (T, 4, 8, 3))
    key = jax.random.PRNGKey(20)
    want = j_make_ensemble_rollout(jm, N, TAU, collect)(v, jnp.asarray(lf), key)
    got = make_ensemble_rollout(tm, N, TAU, collect)(
        torch.tensor(lf), eps=_jax_rollout_eps(key, tm.cfg, N, T))
    if collect == "fields":
        assert got.shape == (T, N, 16, 32, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        return
    for k in ("mean", "var"):
        assert got[k].shape == (T, 16, 32, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4)


def test_rollout_with_generator_is_seeded_and_finite(pair):
    _, _, tm = pair
    lf = torch.tensor(_np(21, (2, 4, 8, 3)))
    roll = make_ensemble_rollout(tm, 3, TAU)
    a = roll(lf, torch.Generator().manual_seed(0))
    b = roll(lf, torch.Generator().manual_seed(0))
    assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"], b["var"])
    assert torch.isfinite(a["mean"]).all() and (a["var"] >= 0).all()
    with pytest.raises(ValueError):
        make_ensemble_rollout(tm, 1, TAU)
    with pytest.raises(ValueError):
        roll(lf, eps=[])
