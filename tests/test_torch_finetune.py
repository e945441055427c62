"""Parity of the port's sample-path fine-tune (``train/finetune.py``) with
the JAX package's, on the CPU at the tiny model of ``test_torch_train.py``
(2 scales x 2 steps, width 8, float32): each loss term and its gradient,
one window of the composite loss with every parameter's gradient and
log_tau's, two windows of the trajectory step (parameters after the
Adam steps), the finite-update guard, the optimizer against its optax
chain, and the scope masks.

JAX weights cross through ``tpuflow_torch.convert.from_flax`` (perturbed
so the zero-init heads and priors compute something); JAX's latent draws
are rebuilt from its keys (split per window, per timestep, then per
scale, as ``make_finetune_trajectory_step``, ``make_finetune_loss`` and
``MultiScaleGlow.reverse`` split them) and handed to the port as
``eps``. Tolerances are stated at each test.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpuflow.train.finetune as jft
from tpuflow.configs.config import ModelConfig as JModelConfig
from tpuflow.data import generate_case as j_generate_case
from tpuflow.eval.stats import ensemble_crps as j_ensemble_crps
from tpuflow.models import TMGlow as JTMGlow
from tpuflow.models import init_lstm_state as j_init_lstm_state
from tpuflow_torch.configs import ModelConfig
from tpuflow_torch.convert import from_flax
from tpuflow_torch.eval.stats import ensemble_crps
from tpuflow_torch.models import TMGlow, init_lstm_state, latent_shapes, scale_shapes
from tpuflow_torch.train import finetune as tft

torch.set_num_threads(1)

TINY = dict(
    n_scales=2, n_flow_steps=2, channels=3, hf_shape=(16, 32), lf_shape=(4, 8),
    coupling_width=8, coupling_layers=2, growth_rate=4, encoder_width=8,
    lstm_hidden=8, cond_channels=8, compute_dtype="float32",
)
B, M, W = 2, 3, 2
LAMBDAS = (0.5, 0.05, 0.3)  # crps, spec, disp: all nonzero


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    lf, hf = j_generate_case("backward-step", B, 2 * W + 1, (16, 32), (4, 8), 0, 3)
    return lf, hf  # (B, 5, ...): two windows of 2 and a trailing partial one


@pytest.fixture(scope="module")
def pair(data):
    """(JAX model, perturbed variables, the port's model with them)."""
    lf, hf = data
    jm = JTMGlow(JModelConfig(conv_layout="nhwc", **TINY))
    v0 = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(hf[:, 0]), jnp.asarray(lf[:, 0]),
        j_init_lstm_state(jm.cfg, (B,))))
    rng = np.random.default_rng(3)
    v = {**v0, "params": jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v0["params"])}
    return jm, v


def _port(v):
    tm = TMGlow(ModelConfig(**TINY), device="cpu")
    tm.load_state_dict(from_flax(v, tm))
    return tm


def _spec_targets(hf):
    return np.stack([np.asarray(jft.converged_log_spectra(jnp.asarray(hf[i])))
                     for i in range(hf.shape[0])])


def _jax_draws(key, b, window):
    """The port's eps for one window from JAX's window key: split per
    timestep, then per scale."""
    cfg = ModelConfig(**TINY)
    shapes = latent_shapes(cfg, b * M)
    return [[torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
             for k, s in zip(jax.random.split(kt, cfg.n_scales), shapes)]
            for kt in jax.random.split(key, window)]


def _grads_as_port(g_params, v, tm):
    return from_flax({"params": jax.device_get(g_params), "buffers": v["buffers"]}, tm)


# ------------------------------------------------------------- loss terms


def _members(seed, zero_modes=False):
    x = _np(seed, (W, B, M, 16, 32, 3))
    if zero_modes:
        # Trajectory 0's velocities are 0 in every window and member, so
        # its fluctuations and every one of its Fourier modes are exactly 0.
        x[:, 0, ..., :2] = 0.0
    return x


@pytest.mark.parametrize("zero_modes", [False, True])
@pytest.mark.parametrize("term", ["spec", "disp", "crps", "bound", "log_spectra"])
def test_loss_term_and_gradient_match_jax(term, zero_modes):
    """Each loss term and its gradient with respect to the members
    (W, B, M, H, Wd, C) against jax.grad: the value to 1e-5 relative,
    the gradient to 1e-5 x max(1, max|g|); also where every mode of a
    trajectory's member spectrum is exactly 0 (|fft|^2 at 0)."""
    mem = _members(10, zero_modes)
    hf_tm = _np(11, (W, B, 16, 32, 3))
    target = _spec_targets(np.moveaxis(_np(12, (W * 4, B, 16, 32, 3)), 1, 0))
    weights = _np(13, (B, target.shape[1]))
    fns = {
        "spec": (lambda x: jft.spectral_target_mse(x, jnp.asarray(target)),
                 lambda x: tft.spectral_target_mse(x, torch.tensor(target))),
        "disp": (lambda x: jft.dispersion_log_mse(x, jnp.asarray(hf_tm)),
                 lambda x: tft.dispersion_log_mse(x, torch.tensor(hf_tm))),
        "crps": (lambda x: jnp.mean(j_ensemble_crps(x, jnp.asarray(hf_tm), axis=2)),
                 lambda x: ensemble_crps(x, torch.tensor(hf_tm), axis=2).mean()),
        "bound": (lambda x: jnp.mean(jax.nn.relu(jnp.abs(4.0 * x) - 8.0) ** 2),
                  lambda x: torch.mean(torch.relu((4.0 * x).abs() - 8.0) ** 2)),
        "log_spectra": (lambda x: jnp.sum(jft.member_log_spectra(x) * weights),
                        lambda x: (tft.member_log_spectra(x) * torch.tensor(weights)).sum()),
    }
    fj, ft = fns[term]
    val_j, g_j = jax.value_and_grad(fj)(jnp.asarray(mem))
    x = torch.tensor(mem, requires_grad=True)
    val_t = ft(x)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    assert np.isfinite(g_j).all() and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(g_j).max()))


def test_member_spectra_targets_and_clipped_tau():
    """The batched member spectra equal each trajectory's own spectrum
    (JAX vmaps it); converged targets match JAX; tau clips at 1.1."""
    mem = _members(14)
    got = tft.member_log_spectra(torch.tensor(mem))
    assert got.shape == (B, 8)  # min(16, 32) / 2 + 1 bins, the mean mode dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(jft.member_log_spectra(jnp.asarray(mem))),
                               rtol=1e-5, atol=1e-5)
    ref = _np(15, (24, 16, 32, 3))
    np.testing.assert_allclose(tft.converged_log_spectra(torch.tensor(ref)).numpy(),
                               np.asarray(jft.converged_log_spectra(jnp.asarray(ref))),
                               rtol=1e-5, atol=1e-5)
    lt = np.log(np.array([0.5, 1.0, 5.0], np.float32))
    np.testing.assert_allclose(tft.clipped_tau(torch.tensor(lt)).numpy(),
                               np.asarray(jft.clipped_tau(jnp.asarray(lt))), rtol=1e-6)
    assert float(tft.clipped_tau(torch.tensor(lt)).max()) == pytest.approx(tft._TAU_MAX)


# ------------------------------------------------------------ one window


def test_finetune_loss_window_matches_jax(pair, data):
    """One window (W=2, B=2, M=3, all lambdas nonzero, non-zero initial
    state): the loss and every aux term to 1e-5 relative; every
    parameter's gradient and log_tau's to 1e-4 x max(1, max|g|)."""
    jm, v = pair
    lf, hf = (a[:, :W] for a in data)
    spec = _spec_targets(hf)
    state = [(_np(20 + l, (B, h, w, 8), 0.5), _np(30 + l, (B, h, w, 8), 0.5))
             for l, (h, w) in enumerate(scale_shapes(ModelConfig(**TINY)))]
    log_tau = np.log(np.array([0.8, 0.7], np.float32))
    key = jax.random.PRNGKey(41)
    loss_j = jft.make_finetune_loss(jm, M)
    (val_j, aux_j), (g_p, g_tau) = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        (v["params"], jnp.asarray(log_tau)), v["buffers"], jnp.asarray(lf), jnp.asarray(hf),
        jnp.asarray(spec), tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in state), key,
        *map(jnp.float32, LAMBDAS))
    tm = _port(v)
    lt = torch.tensor(log_tau, requires_grad=True)
    val_t, aux_t = tft.make_finetune_loss(tm, M)(
        lt, torch.tensor(lf), torch.tensor(hf), torch.tensor(spec),
        tuple((torch.tensor(h), torch.tensor(c)) for h, c in state), *LAMBDAS,
        _jax_draws(key, B, W))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    for k in ("bpd", "crps", "spec", "disp", "bound"):
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]), rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for (hj, _), (ht, _) in zip(aux_j["state"], aux_t["state"]):
        np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)
    want = _grads_as_port(g_p, v, tm)
    named = dict(tm.named_parameters())
    assert len(named) == len(jax.tree.leaves(g_p))
    for name, p in [*named.items(), ("log_tau", lt)]:
        g = np.asarray(g_tau) if name == "log_tau" else want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(g).max()), err_msg=name)


# --------------------------------------------------- the trajectory step


def _jax_step(jm, v, scope, learn_tau, lr, lf, hf, spec, key, log_tau):
    mask = jft._scope_mask(v["params"], scope) if scope != "all" else None
    tx = jft.make_finetune_optimizer(lr, 100.0, learn_tau, scope_mask=mask)
    opt_params = (v["params"], jnp.asarray(log_tau))
    step = jax.jit(jft.make_finetune_trajectory_step(jm, tx, W, M))
    return step(opt_params, v["buffers"], tx.init(opt_params), jnp.asarray(lf), jnp.asarray(hf),
                jnp.asarray(spec), key, *map(jnp.float32, LAMBDAS))


def _port_step(tm, scope, learn_tau, lr, log_tau):
    lt = torch.tensor(log_tau, requires_grad=True)
    mask = tft._scope_mask(tm, scope) if scope != "all" else None
    opt = tft.make_finetune_optimizer(tm, lt, lr, 100.0, learn_tau, scope_mask=mask)
    return lt, opt, tft.make_finetune_trajectory_step(tm, opt, W, M)


def test_trajectory_step_matches_jax(pair, data):
    """Two windows (scope "nets", learn_tau, lr 1e-5: the flagship's
    recipe), the optimizer stepping between them and the state carried
    with its gradient cut: every metric to 1e-5 relative, and every
    parameter and log_tau after the two Adam steps to 1e-5 relative (of
    max(1, max|p|) per tensor). Parameters outside the scope are
    unchanged, bit for bit."""
    jm, v = pair
    lf, hf = data
    spec = _spec_targets(hf)
    log_tau = np.log(np.array([0.8, 0.7], np.float32))
    key = jax.random.PRNGKey(7)
    (p_j, lt_j), _, m_j = _jax_step(jm, v, "nets", True, 1e-5, lf, hf, spec, key, log_tau)
    tm = _port(v)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    lt, _, step = _port_step(tm, "nets", True, 1e-5, log_tau)
    draws = [_jax_draws(k, B, W) for k in jax.random.split(key, 2)]
    m_t = step(torch.tensor(lf), torch.tensor(hf), torch.tensor(spec), draws, *LAMBDAS)
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]), rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    assert float(m_t["skipped_windows"]) == 0.0
    want = from_flax({"params": jax.device_get(p_j), "buffers": v["buffers"]}, tm)
    mask = tft._scope_mask(tm, "nets")
    moved = 0
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=name)
        if not mask[name]:
            assert torch.equal(p.detach(), before[name]), name
        moved += not torch.equal(p.detach(), before[name])
    assert moved == sum(mask.values())
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lt_j), rtol=1e-5)
    assert not np.allclose(lt.detach().numpy(), log_tau)


def test_guard_skips_a_nonfinite_window(pair, data):
    """A window with a NaN in its HF target: its loss is NaN, so no
    parameter, no log_tau, no Adam moment and no step count changes
    (bit for bit), it counts as 1 skipped, and the epoch metrics are
    means over the finite windows only (here: none, so 0)."""
    jm, v = pair
    lf, hf = (a[:, :W] for a in data)
    spec = torch.tensor(_spec_targets(hf))
    tm = _port(v)
    lt, opt, step = _port_step(tm, "all", True, 1e-3, np.log(np.array([0.8, 0.7], np.float32)))
    m1 = step(torch.tensor(lf), torch.tensor(hf), spec, torch.Generator().manual_seed(0),
              *LAMBDAS)
    assert float(m1["skipped_windows"]) == 0.0 and np.isfinite(float(m1["loss"]))
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tau = lt.detach().clone()
    adam = copy.deepcopy(opt.adam.state_dict())
    assert all(float(s["step"]) == 1.0 for s in adam["state"].values())
    bad = hf.copy()
    bad[0, 1, 3, 5, 0] = np.nan
    m2 = step(torch.tensor(lf), torch.tensor(bad), spec, torch.Generator().manual_seed(1),
              *LAMBDAS)
    assert float(m2["skipped_windows"]) == 1.0
    assert all(float(m2[k]) == 0.0 for k in ("loss", "bpd", "grad_norm"))
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), params[n]), n
    assert torch.equal(lt.detach(), tau)
    after = opt.adam.state_dict()
    assert after["state"].keys() == adam["state"].keys()
    for i, s in adam["state"].items():
        for k, t in s.items():
            assert torch.equal(after["state"][i][k], t), (i, k)


# -------------------------------------------------------------- optimizer


@pytest.mark.parametrize("learn_tau", [True, False])
@pytest.mark.parametrize("scope", ["all", "nets", "priors"])
def test_optimizer_matches_optax(pair, scope, learn_tau):
    """Five steps on identical gradients against the JAX package's optax
    chain (clip over params and log_tau, fires at steps 2 and 4; Adam;
    updates outside the scope zeroed; log_tau's scaled by 10, or 0):
    every parameter and log_tau to 1e-6."""
    jm, v = pair
    lr, clip = 1e-3, 5.0
    mask_j = jft._scope_mask(v["params"], scope) if scope != "all" else None
    tx = jft.make_finetune_optimizer(lr, clip, learn_tau, scope_mask=mask_j)
    log_tau = np.log(np.array([0.8, 0.7], np.float32))
    pj = (v["params"], jnp.asarray(log_tau))
    st = tx.init(pj)
    tm = _port(v)
    lt = torch.tensor(log_tau, requires_grad=True)
    opt = tft.make_finetune_optimizer(
        tm, lt, lr, clip, learn_tau,
        scope_mask=tft._scope_mask(tm, scope) if scope != "all" else None)
    names = [n for n, _ in tm.named_parameters()]
    fired = []
    for n, sc in enumerate([0.01, 3.0, 0.02, 10.0, 0.01]):
        leaves, treedef = jax.tree.flatten(v["params"])
        g_leaves = [_np(100 * n + i, a.shape, sc) for i, a in enumerate(leaves)]
        g_tree = jax.tree.unflatten(treedef, g_leaves)
        g_tau = _np(999 + n, (2,), sc)
        upd, st = tx.update((jax.tree.map(jnp.asarray, g_tree), jnp.asarray(g_tau)), st, pj)
        pj = optax.apply_updates(pj, upd)
        as_port = from_flax({"params": g_tree, "buffers": v["buffers"]}, tm)
        grads = [as_port[k].clone() for k in names] + [torch.tensor(g_tau)]
        fired.append(float(opt.clip(grads)) >= clip)
        opt.apply(grads)
        want = from_flax({"params": jax.device_get(pj[0]), "buffers": v["buffers"]}, tm)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                       rtol=0, err_msg=name)
        np.testing.assert_allclose(lt.detach().numpy(), np.asarray(pj[1]), atol=1e-6, rtol=0)
    assert fired == [False, True, False, True, False]
    assert np.array_equal(lt.detach().numpy(), log_tau) != learn_tau


@pytest.mark.parametrize("scope", ["all", "nets", "priors"])
def test_scope_mask_matches_jax(pair, scope):
    """The port's masks, from its parameter names, against JAX's
    _scope_mask mapped leaf by leaf through convert.from_flax."""
    jm, v = pair
    mask_j = (jax.tree.map(lambda _: True, v["params"]) if scope == "all"
              else jft._scope_mask(v["params"], scope))
    as_arrays = jax.tree.map(lambda m, a: np.full(a.shape, float(m), np.float32),
                             mask_j, v["params"])
    tm = _port(v)
    want = from_flax({"params": as_arrays, "buffers": v["buffers"]}, tm)
    got = tft._scope_mask(tm, scope)
    assert list(got) == [n for n, _ in tm.named_parameters()]
    for name, flag in got.items():
        assert flag == bool(want[name].numpy().all()) and (flag or not want[name].any()), name
    assert 0 < sum(got.values()) <= len(got)
    with pytest.raises(ValueError, match="train_scope"):
        tft._scope_mask(tm, "decoder")


def test_init_lstm_state_shapes_match():
    """The fine-tune starts each trajectory from the zero state of the
    trainer (per scale (B, H_l, W_l, hidden))."""
    cfg = ModelConfig(**TINY)
    got = init_lstm_state(cfg, B, "cpu")
    want = j_init_lstm_state(JModelConfig(**TINY), (B,))
    assert [tuple(h.shape) for h, _ in got] == [tuple(h.shape) for h, _ in want]


def test_sample_step_matches_jax(pair, data):
    """TMGlow.sample_step (the trainer's periodic sample) against JAX's
    with its draws handed in (split per scale): 1e-4."""
    jm, v = pair
    lf, _ = data
    state = [(_np(50 + l, (B, h, w, 8), 0.5), _np(60 + l, (B, h, w, 8), 0.5))
             for l, (h, w) in enumerate(scale_shapes(ModelConfig(**TINY)))]
    key = jax.random.PRNGKey(8)
    x_j, s_j = jax.jit(lambda *a: jm.apply(*a, 0.7, method=JTMGlow.sample_step))(
        v, jnp.asarray(lf[:, 1]), tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in state), key)
    cfg = ModelConfig(**TINY)
    eps = [torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
           for k, s in zip(jax.random.split(key, cfg.n_scales), latent_shapes(cfg, B))]
    with torch.no_grad():
        x_t, s_t = _port(v).sample_step(
            torch.tensor(lf[:, 1]), tuple((torch.tensor(h), torch.tensor(c)) for h, c in state),
            0.7, eps=eps)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-4, rtol=1e-4)
    for (hj, _), (ht, _) in zip(s_j, s_t):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)
