"""Parity of the port's training slice with the JAX package, on the CPU at
the tiny model of ``tests/test_kernels.py`` (2 scales x 2 steps, width 8,
float32): the fused coupling's autograd, ActNorm's data-dependent init,
the NLL step, one BPTT window's loss and gradients, the optimizer, the
procedural data, the held-out NLL, and the trainer and its CLI.

JAX weights come from ``TMGlow(...).init`` (perturbed, so the zero-init
coupling heads and priors compute something) and cross through
``tpuflow_torch.convert.from_flax``; JAX's gradients cross the same way,
so each of the port's parameters is held against its own Flax leaf. The
JAX model runs its default XLA coupling path, the port its fused
coupling; at float32 the two compute the same function up to summation
order. Tolerances are stated at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpuflow.kernels.coupling_fused as cfk
from tpuflow.configs.config import DataConfig as JDataConfig
from tpuflow.configs.config import ModelConfig as JModelConfig
from tpuflow.data import generate_case as j_generate_case
from tpuflow.data import load_dataset as j_load_dataset
from tpuflow.eval.rollout import make_nll_eval as j_make_nll_eval
from tpuflow.models import TMGlow as JTMGlow
from tpuflow.models import init_lstm_state as j_init_lstm_state
from tpuflow.train.step import make_optimizer as j_make_optimizer
from tpuflow.train.step import make_trajectory_train_step as j_make_trajectory_train_step
from tpuflow.train.step import window_bpd_fn as j_window_bpd_fn
from tpuflow_torch.cli.train import main as train_main
from tpuflow_torch.configs import DataConfig, ModelConfig, load_case
from tpuflow_torch.convert import from_flax
from tpuflow_torch.data import generate_case, load_dataset
from tpuflow_torch.eval import make_nll_eval
from tpuflow_torch.flows import ActNorm
from tpuflow_torch.kernels.coupling_fused import fused_coupling_autograd
from tpuflow_torch.models import TMGlow, init_lstm_state, scale_shapes
from tpuflow_torch.utils.logging import MetricsLogger
from tpuflow_torch.train import (
    Checkpointer,
    Trainer,
    clip_by_global_norm_,
    make_optimizer,
    trajectory_train_step,
    window_bpd_fn,
)

torch.set_num_threads(1)

TINY = dict(
    n_scales=2, n_flow_steps=2, channels=3, hf_shape=(16, 32), lf_shape=(4, 8),
    coupling_width=8, coupling_layers=2, growth_rate=4, encoder_width=8,
    lstm_hidden=8, cond_channels=8, compute_dtype="float32",
)
B = 2


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _state_np(seed, cfg, b=B):
    return [(_np(seed + l, (b, h, w, cfg.lstm_hidden), 0.5),
             _np(seed + 10 + l, (b, h, w, cfg.lstm_hidden), 0.5))
            for l, (h, w) in enumerate(scale_shapes(cfg))]


def _jstate(s):
    return tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in s)


def _tstate(s):
    return tuple((torch.tensor(h), torch.tensor(c)) for h, c in s)


@pytest.fixture(scope="module")
def data():
    lf, hf = j_generate_case("backward-step", B, 3, (16, 32), (4, 8), 0, 3)
    return lf, hf  # (B, T, ...) each


@pytest.fixture(scope="module")
def pair(data):
    """(JAX model, its variables from init on the first frame, the same
    perturbed, the port's model with the perturbed weights)."""
    lf, hf = data
    jm = JTMGlow(JModelConfig(conv_layout="nhwc", **TINY))
    v0 = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(hf[:, 0]), jnp.asarray(lf[:, 0]),
        j_init_lstm_state(jm.cfg, (B,))))
    rng = np.random.default_rng(3)
    v = {**v0, "params": jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v0["params"])}
    tm = TMGlow(ModelConfig(**TINY), device="cpu")
    tm.load_state_dict(from_flax(v, tm))
    return jm, v0, v, tm


# --------------------------------------------------------------- K2 autograd


def _k2_case(b, h0c_batch, seed=0, width=16, growth=8, layers=3, ca=6):
    total0 = layers * growth + 2 * ca
    rng = np.random.default_rng(seed)
    r = lambda s, k=1.0: (k * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return dict(
        xa=r((b, 8, 16, ca)), xb=r((b, 8, 16, ca)), h0c=r((h0c_batch, 8, 16, width), 0.5),
        win0=r((9 * ca, width), 0.2), b0=r((width,), 0.1),
        wjs=[r((9 * (width if j == 0 else growth), total0 - j * growth), 0.1)
             for j in range(layers + 1)],
        bj0=r((total0,), 0.1), width=width, growth=growth, layers=layers,
    )


def _packed_to_oihw(w):
    """(9*cin, cout) rows (dy, dx, cin) -> OIHW."""
    cin = w.shape[0] // 9
    return np.ascontiguousarray(w.reshape(3, 3, cin, -1).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0c_batch", [1, 3])
def test_k2_autograd_matches_jax_grad(h0c_batch, reverse):
    """Gradients of sum(y^2) + sum(ld^2) through the port's autograd
    Function (plain forward on the CPU, recompute backward) against
    jax.grad through xla_reference, for xa, xb, h0c and every weight, at
    the tolerance of the JAX package's own fused-gradient test
    (atol 2e-6 x max(1, max|g|), rtol 2e-5)."""
    c = _k2_case(3, h0c_batch)
    cfg = cfk._cfg(c["width"], c["growth"], c["layers"], jnp.float32, reverse)

    def loss_j(xa, xb, h0c, win0, b0, wjs, bj0):
        y, ld = cfk.xla_reference(xa, xb, h0c, win0, b0.reshape(1, -1), wjs,
                                  bj0.reshape(1, -1), cfg)
        return jnp.sum(y**2) + jnp.sum(ld**2)

    args = [c[k] for k in ("xa", "xb", "h0c", "win0", "b0")] + [tuple(c["wjs"]), c["bj0"]]
    g_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(7))))(*jax.tree.map(jnp.asarray, args))
    t = {k: torch.tensor(c[k], requires_grad=True) for k in ("xa", "xb", "h0c", "b0", "bj0")}
    t["win0"] = torch.tensor(_packed_to_oihw(c["win0"]), requires_grad=True)
    t["wjs"] = [torch.tensor(_packed_to_oihw(w), requires_grad=True) for w in c["wjs"]]
    y, ld = fused_coupling_autograd(t["xa"], t["xb"], t["h0c"], t["win0"], t["b0"], t["wjs"],
                                    t["bj0"], torch.float32, reverse=reverse)
    (y.pow(2).sum() + ld.pow(2).sum()).backward()
    pairs = [(t[k].grad.numpy(), np.asarray(g)) for k, g in zip(("xa", "xb", "h0c"), g_j)]
    pairs.append((t["win0"].grad.numpy(), _packed_to_oihw(np.asarray(g_j[3]))))
    pairs.append((t["b0"].grad.numpy(), np.asarray(g_j[4])))
    pairs += [(w.grad.numpy(), _packed_to_oihw(np.asarray(g))) for w, g in zip(t["wjs"], g_j[5])]
    pairs.append((t["bj0"].grad.numpy(), np.asarray(g_j[6])))
    for got, want in pairs:
        np.testing.assert_allclose(got, want, atol=2e-6 * max(1.0, np.abs(want).max()),
                                   rtol=2e-5)


# ------------------------------------------------------------ model steps


def test_actnorm_data_init_matches_jax_init(pair, data):
    """Every ActNorm initialised from the port's forward on the batch of
    JAX's model.init, every other leaf carried across: 1e-5."""
    jm, v0, _, _ = pair
    lf, hf = data
    tm = TMGlow(ModelConfig(**TINY), device="cpu")
    tm.load_state_dict(from_flax(v0, tm))
    actnorms = {n: m for n, m in tm.named_modules() if isinstance(m, ActNorm)}
    assert len(actnorms) == 4
    with torch.no_grad():
        for m in actnorms.values():
            m.bias.zero_()
            m.log_scale.zero_()
            m.initialized.fill_(False)
    tm.data_init(torch.tensor(hf[:, 0]), torch.tensor(lf[:, 0]), init_lstm_state(tm.cfg, B, "cpu"))
    want = from_flax(v0, tm)
    for name, m in actnorms.items():
        assert bool(m.initialized) and not m.init_pending
        for leaf in ("bias", "log_scale"):
            np.testing.assert_allclose(getattr(m, leaf).detach().numpy(),
                                       want[f"{name}.{leaf}"].numpy(), atol=1e-5, rtol=1e-5)


def test_actnorm_init_statistics():
    """ddof-0 std, the clamp at +-7, and no init in reverse."""
    m = ActNorm(3)
    x = torch.tensor(_np(0, (4, 5, 6, 3)))
    x[..., 2] = 0.25  # a constant channel: -log(1e-6) clamps to 7
    m.init_pending = True
    m(x, reverse=True)
    assert m.init_pending and not bool(m.initialized)
    y, _ = m(x)
    assert bool(m.initialized) and not m.init_pending
    np.testing.assert_allclose(m.log_scale[:2].detach().numpy(),
                               -np.log(x[..., :2].numpy().std(axis=(0, 1, 2)) + 1e-6), rtol=1e-5)
    assert m.log_scale[2].item() == 7.0
    np.testing.assert_allclose(y[..., :2].mean(dim=(0, 1, 2)).detach().numpy(), 0, atol=1e-5)


def test_nll_step_matches_jax(pair, data):
    jm, _, v, tm = pair
    lf, hf = data
    s = _state_np(20, tm.cfg)
    bpd_j, st_j = jax.jit(jm.apply)(v, jnp.asarray(hf[:, 1]), jnp.asarray(lf[:, 1]), _jstate(s))
    bpd_t, st_t = tm.nll_step(torch.tensor(hf[:, 1]), torch.tensor(lf[:, 1]), _tstate(s))
    bpd_call, _ = tm(torch.tensor(hf[:, 1]), torch.tensor(lf[:, 1]), _tstate(s))
    assert torch.equal(bpd_call, bpd_t)
    np.testing.assert_allclose(bpd_t.detach().numpy(), np.asarray(bpd_j), rtol=1e-5, atol=1e-5)
    for (hj, cj), (ht, ct) in zip(st_j, st_t):
        np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)


def test_encode_reconstruct_roundtrip(pair, data):
    jm, _, v, tm = pair
    lf, hf = data
    s = _state_np(30, tm.cfg)
    with torch.no_grad():
        lat, logdet, logp, _ = tm.encode_step(torch.tensor(hf[:, 0]), torch.tensor(lf[:, 0]),
                                              _tstate(s))
        x_rec, _ = tm.reconstruct_step(lat, torch.tensor(lf[:, 0]), _tstate(s))
    np.testing.assert_allclose(x_rec.numpy(), hf[:, 0], atol=1e-4, rtol=0)
    lat_j, ld_j, lp_j, _ = jax.jit(lambda *a: jm.apply(*a, method=JTMGlow.encode_step))(
        v, jnp.asarray(hf[:, 0]), jnp.asarray(lf[:, 0]), _jstate(s))
    for a, b in zip(lat, lat_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(ld_j), rtol=1e-5, atol=1e-2)


def test_nll_and_sample_step_matches_jax(pair, data):
    """Teacher-forced bpd and member draws under one conditioning, with
    JAX's latent draws handed to the port."""
    jm, _, v, tm = pair
    lf, hf = data
    s = _state_np(40, tm.cfg)
    m_members, tau = 3, 0.8
    rng = jax.random.PRNGKey(41)
    bpd_j, mem_j, _ = jax.jit(
        lambda *a: jm.apply(*a, tau, m_members, method=JTMGlow.nll_and_sample_step))(
        v, jnp.asarray(hf[:, 0]), jnp.asarray(lf[:, 0]), _jstate(s), rng)
    shapes, c = [], tm.cfg.channels
    for l, (h, w) in enumerate(scale_shapes(tm.cfg)):
        c *= 4
        ch = c // 2 if l < tm.cfg.n_scales - 1 else c
        shapes.append((B * m_members, h, w, ch))
        c = ch
    eps = [torch.tensor(np.asarray(jax.random.normal(k, sh, jnp.float32)))
           for k, sh in zip(jax.random.split(rng, tm.cfg.n_scales), shapes)]
    with torch.no_grad():
        bpd_t, mem_t, _ = tm.nll_and_sample_step(
            torch.tensor(hf[:, 0]), torch.tensor(lf[:, 0]), _tstate(s), tau, m_members, eps=eps)
    assert mem_t.shape == (B, m_members, 16, 32, 3)
    np.testing.assert_allclose(bpd_t.numpy(), np.asarray(bpd_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mem_t.numpy(), np.asarray(mem_j), atol=1e-4, rtol=1e-4)


def test_window_loss_and_every_gradient_match_jax(pair, data):
    """One BPTT window (B=2, 3 steps, non-zero initial state): the loss
    to 1e-5 relative, every parameter's gradient to 1e-4 x max(1,
    max|g|) against jax.value_and_grad(window_bpd_fn), leaf by leaf."""
    jm, _, v, tm = pair
    lf, hf = data
    s = _state_np(50, tm.cfg)
    loss_j = j_window_bpd_fn(jm)
    (val_j, st_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        v["params"], v["buffers"], jnp.asarray(lf), jnp.asarray(hf), _jstate(s))
    tm.zero_grad(set_to_none=True)
    val_t, st_t = window_bpd_fn(tm)(torch.tensor(lf), torch.tensor(hf), _tstate(s))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    for (hj, _), (ht, _) in zip(st_j, st_t):
        np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)
    want = from_flax({"params": jax.device_get(g_j), "buffers": v["buffers"]}, tm)
    named = dict(tm.named_parameters())
    assert len(named) == len(jax.tree.leaves(g_j))
    for name, p in named.items():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-4 * max(1.0, np.abs(g).max()),
                                   rtol=0, err_msg=name)


def test_trajectory_step_matches_jax(pair):
    """Two BPTT windows of one trajectory batch, the optimizer stepping
    between them and the state carried with its gradient cut: each
    window's bpd and the mean gradient norm against the JAX package's
    make_trajectory_train_step (1e-5 relative; the second window sees
    parameters one Adam step apart, moved by 5e-4 each)."""
    jm, _, v, tm = pair
    lf, hf = j_generate_case("backward-step", B, 5, (16, 32), (4, 8), 4, 3)
    tx = j_make_optimizer(5e-4, 0.995, 100.0)
    step = jax.jit(j_make_trajectory_train_step(jm, tx, window=2))
    _, _, m_j = step(v["params"], v["buffers"], tx.init(v["params"]), jnp.asarray(lf),
                     jnp.asarray(hf))
    tm2 = TMGlow(ModelConfig(**TINY), device="cpu")
    tm2.load_state_dict(tm.state_dict())
    opt, sched = make_optimizer(tm2.parameters(), 5e-4, 0.995)
    m_t = trajectory_train_step(tm2, opt, sched, 100.0, 2, torch.tensor(lf), torch.tensor(hf))
    assert m_t["bpd"].shape == (2,)  # the trailing partial window is dropped
    np.testing.assert_allclose(m_t["bpd"].numpy(), np.asarray(m_j["bpd_per_window"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m_t["grad_norm"].mean().item(), float(m_j["grad_norm"]),
                               rtol=1e-4)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_matches_optax(weight_decay):
    """Five steps on identical gradients: clip (fires at steps 1 and 3),
    optional decayed weights, Adam, continuous lr decay; params 1e-6.

    At the config's lr, 5e-4: optax takes Adam's bias corrections in
    float32 (1 - 0.999 rounds with a relative error of 1.3e-5), torch in
    float64, so an update differs by ~7e-6 of itself, 3e-9 here. A
    stepped decay or a missing clip moves a parameter by ~1e-4."""
    lr, decay, clip = 5e-4, 0.5, 1.0
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: _np(i, s) for i, (k, s) in enumerate(shapes.items())}
    scales = [0.1, 3.0, 0.2, 10.0, 0.1]
    grads = [{k: _np(100 + 10 * n + i, s, sc) for i, (k, s) in enumerate(shapes.items())}
             for n, sc in enumerate(scales)]
    tx = j_make_optimizer(lr, decay, clip, weight_decay, decay_every=2)
    pj = jax.tree.map(jnp.asarray, p0)
    st = tx.init(pj)
    params = [torch.tensor(p0[k], requires_grad=True) for k in shapes]
    opt, sched = make_optimizer(params, lr, decay, weight_decay, decay_every=2)
    fired = []
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, pj)
        pj = optax.apply_updates(pj, upd)
        gt = [torch.tensor(g[k]) for k in shapes]
        norm = clip_by_global_norm_(gt, clip)
        fired.append(float(norm) >= clip)
        for p, gg in zip(params, gt):
            p.grad = gg
        before = params[0].detach().clone()
        opt.step()
        sched.step()
        assert (params[0].detach() - before).abs().mean() > 1e-5
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]), atol=1e-6, rtol=0)
    assert fired == [False, True, False, True, False]


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("case", ["backward-step", "cylinder-array"])
def test_generate_case_identical_to_jax(case, version):
    got = generate_case(case, 2, 5, (16, 32), (4, 8), 7, version)
    want = j_generate_case(case, 2, 5, (16, 32), (4, 8), 7, version)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dataset_matches_jax(tmp_path):
    """Synthetic and .npz splits: normalized arrays, norm constants, epoch
    order and windows equal the JAX package's."""
    kw = dict(n_train_traj=5, n_test_traj=2, train_steps=7, batch_size=2, window=3)
    mc = ModelConfig(**TINY)
    for split in ("train", "test"):
        got = load_dataset(DataConfig(**kw), mc, split)
        want = j_load_dataset(JDataConfig(**kw), JModelConfig(**TINY), split)
        assert np.array_equal(got.lf, want.lf) and np.array_equal(got.hf, want.hf)
        for k, val in got.norm.to_dict().items():
            assert np.array_equal(val, want.norm.to_dict()[k])
    ds = load_dataset(DataConfig(**kw), mc, "train")
    want = j_load_dataset(JDataConfig(**kw), JModelConfig(**TINY), "train")
    order = [i.tolist() for i in ds.batch_indices(3, 2)]
    assert order == [i.tolist() for i in want.batch_indices(3, 2)] and len(order) == 2
    wins = list(ds.windows(ds.lf[:2], ds.hf[:2], 3))
    assert len(wins) == 2 and wins[1][0].shape == (2, 3, 4, 8, 3)
    with pytest.raises(ValueError, match="exceeds"):
        list(ds.windows(ds.lf, ds.hf, 8))
    for split in ("train", "test"):
        lf, hf = generate_case("backward-step", 3, 4, (16, 32), (4, 8), split == "test", 1)
        np.savez(tmp_path / f"backward-step_{split}.npz", lf=lf, hf=hf)
    npz = DataConfig(synthetic=False, data_dir=str(tmp_path))
    got = load_dataset(npz, mc, "test")
    want = j_load_dataset(JDataConfig(synthetic=False, data_dir=str(tmp_path)),
                          JModelConfig(**TINY), "test")
    assert np.array_equal(got.hf, want.hf)


def test_make_nll_eval_matches_jax(pair, data):
    jm, _, v, tm = pair
    lf, hf = data
    want = jax.jit(j_make_nll_eval(jm))(v, jnp.asarray(lf), jnp.asarray(hf))
    got = make_nll_eval(tm)(torch.tensor(lf), torch.tensor(hf))
    assert got.shape == (3, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ trainer


def _case_cfg(tmp_path, **over):
    base = {f"model.{k}": (",".join(map(str, v)) if isinstance(v, tuple) else v)
            for k, v in TINY.items()}
    base.update({"data.n_train_traj": 4, "data.n_test_traj": 2, "data.train_steps": 6,
                 "data.batch_size": 2, "data.window": 3, "train.epochs": 2,
                 "train.log_every": 0, "train.checkpoint_dir": str(tmp_path)})
    base.update(over)
    return load_case("backward-step", base)


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def test_trainer_deterministic_and_resume_equals_uninterrupted(tmp_path):
    log = tmp_path / "a_log.csv"
    a = Trainer(_case_cfg(tmp_path / "a", **{"train.log_every": 1}), device="cpu",
                logger=MetricsLogger(log, quiet=True))
    out_a = a.run()
    a.logger.close()
    rows = log.read_text().splitlines()[1:]
    assert out_a["epoch"] == 2 and len(rows) == 8  # 2 epochs x 2 batches x 2 windows
    assert all(np.isfinite(float(v)) for r in rows for v in r.split(",")[3:5])
    b = Trainer(_case_cfg(tmp_path / "b"), device="cpu")
    b.run()
    for k, val in _params(a).items():
        assert torch.equal(val, _params(b)[k]), k
    # One epoch, a fresh Trainer resuming from its checkpoint, one more.
    c = Trainer(_case_cfg(tmp_path / "c", **{"train.epochs": 1}), device="cpu")
    c.run()
    c2 = Trainer(_case_cfg(tmp_path / "c"), device="cpu")
    c2.init_or_resume()
    assert c2.epoch == 1 and c2.global_step == 4
    c2.run()
    for k, val in _params(a).items():
        assert torch.equal(val, _params(c2)[k]), k
    assert Checkpointer(tmp_path / "c" / "backward-step").steps() == [1, 2]


def test_trainer_guards_and_validation(tmp_path):
    with pytest.raises(ValueError, match="exceeds"):
        Trainer(_case_cfg(tmp_path, **{"data.window": 7}), device="cpu")
    t = Trainer(_case_cfg(tmp_path, **{"train.epochs": 1, "train.eval_every": 1,
                                       "data.device_resident": False}), device="cpu")
    out = t.run()
    assert np.isfinite(out["val_bpd"])
    assert (tmp_path / "backward-step" / "val_log.csv").exists()
    t.close()
    again = Trainer(_case_cfg(tmp_path, **{"train.epochs": 1}), device="cpu")
    again.init_or_resume()
    before = _params(again)
    out = again.run()
    assert out["windows_per_sec"] == 0.0 and again.epoch == 1
    assert all(torch.equal(v, _params(again)[k]) for k, v in before.items())
    ck = Checkpointer(tmp_path / "k", max_to_keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"x": torch.tensor(s)})
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert int(ck.restore()["x"]) == 3 and ck.restore(2)["x"].item() == 2


def test_cli_trains_on_cpu(tmp_path, capsys):
    over = [f"model.{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in TINY.items()]
    argv = ["backward-step", *over, "data.n_train_traj=2", "data.train_steps=3",
            "data.batch_size=2", "data.window=3", "train.epochs=1", "train.log_every=1",
            f"train.checkpoint_dir={tmp_path}", "--device", "cpu"]
    out = train_main(argv)
    assert out["epoch"] == 1 and np.isfinite(out["mean_bpd"])
    assert "done: epoch=1" in capsys.readouterr().out
    log = (tmp_path / "backward-step" / "train_log.csv").read_text().splitlines()
    assert log[0].startswith("step,wall_s,epoch,bpd,grad_norm") and len(log) == 2
    assert train_main(argv)["windows_per_sec"] == 0.0  # already trained
    with pytest.raises(SystemExit):
        train_main(["backward-step", "--device"])
    assert dataclasses.asdict(load_case("backward-step").train)["grad_clip"] == 100.0
