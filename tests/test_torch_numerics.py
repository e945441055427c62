"""The coupling's two numerics, selected by ``model.use_pallas`` as in the
JAX package, against the JAX package on the CPU at small sizes:

  * ``use_pallas: false`` (the presets' and every committed checkpoint's
    setting): the JAX default XLA path, every bf16 conv output and every
    sum flax computes in bf16 rounded to bf16;
  * ``use_pallas: true``: the JAX package's fused coupling (f32 sums).

Held here: K2's plain version in the default numerics against JAX's
``AffineCoupling(use_pallas=False)`` called eagerly (``jax.disable_jit``:
XLA fuses nothing, so each bf16 op rounds where the program says); the
two numerics bit-equal at f32; the mode threaded from the config to every
``PackedNet`` the port's paths build (rollout, batched and split rollout,
training, the fine-tune, the exported step) and the registered operator;
and a bf16 training window and trajectory step against JAX's in each
numerics, JAX in a subprocess with ``--xla_allow_excess_precision=false``
(with XLA's default, its CPU compiler keeps some bf16 intermediates at f32
inside a fusion under ``jax.jit``, which moves JAX off its own program).

Tolerances are stated at each test.
"""

import contextlib
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.flows import AffineCoupling as JAffineCoupling
from tpuflow_torch.configs import ModelConfig, load_case
from tpuflow_torch.convert import from_flax
from tpuflow_torch.eval import (
    make_batched_ensemble_rollout,
    make_ensemble_rollout,
    make_nll_eval,
)
from tpuflow_torch.flows import AffineCoupling
from tpuflow_torch.kernels import coupling_fused as tk
from tpuflow_torch.kernels import ops
from tpuflow_torch.kernels.coupling_fused import (
    PackedNet,
    fused_coupling_autograd,
    fused_coupling_reference,
    pack_net,
)
from tpuflow_torch.models import TMGlow, init_lstm_state, latent_shapes, perturb_
from tpuflow_torch.train import make_optimizer, trajectory_train_step, window_bpd_fn
from tpuflow_torch.train import finetune as tft
from tpuflow_torch.train.mesh import make_mesh

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, H, W, C, CC = 3, 8, 16, 12, 5
KW = dict(width=16, layers=3, growth_rate=8)


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _perturbed(variables, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    return {**jax.device_get(variables), "params": params}


def _couplings(cond_batch, dtype, seed=0):
    """(x, cond, JAX default-path coupling, its perturbed variables, the
    port's coupling in each numerics on those weights)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, cond = _np(seed + 1, (B, H, W, C)), _np(seed + 2, (cond_batch, H, W, CC))
    jm = JAffineCoupling(dtype=jdt, use_pallas=False, conv_layout="nhwc", **KW)
    v = _perturbed(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(cond)),
                   seed + 3)
    ports = {}
    for use_pallas in (False, True):
        m = AffineCoupling(C, CC, dtype=tdt, use_pallas=use_pallas, **KW)
        m.load_state_dict(from_flax(v, m))
        ports[use_pallas] = m
    return x, cond, jm, v, ports


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cond_batch", [1, B])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_numerics_match_jax_default_path(dtype, cond_batch, reverse):
    """The port's coupling at ``use_pallas=False`` (K2's plain version on
    the CPU) against JAX's ``AffineCoupling(use_pallas=False)`` run eagerly.
    f32: y 2e-5, logdet 2e-4 (summation order only, as
    ``test_torch_flows.py``). bf16: both round the same values at the same
    points; they differ only where an f32 sum, taken in another order, lies
    on a bf16 rounding boundary (one ulp, 2^-8 relative, on a few values):
    y 5e-3 (the card's bf16 tolerance), logdet 1e-5 relative. The fused
    numerics miss the default path by far more at bf16 (asserted: 20x the
    default's error at least), so the check tells the two apart."""
    x, cond, jm, v, ports = _couplings(cond_batch, dtype)
    with jax.disable_jit():
        yj, ldj = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), reverse=reverse)
    yj, ldj = np.asarray(yj), np.asarray(ldj)
    with torch.no_grad():
        yt, ldt = ports[False](_t(x), _t(cond), reverse=reverse)
        yf, _ = ports[True](_t(x), _t(cond), reverse=reverse)
    tol_y, tol_ld = (2e-5, 2e-4) if dtype == "float32" else (5e-3, 1e-5 * np.abs(ldj).max())
    np.testing.assert_allclose(yt.numpy(), yj, atol=tol_y, rtol=1e-5)
    np.testing.assert_allclose(ldt.numpy(), ldj, atol=tol_ld, rtol=1e-5)
    if dtype == "bfloat16":
        err, err_fused = np.abs(yt.numpy() - yj).max(), np.abs(yf.numpy() - yj).max()
        assert err_fused >= 20 * max(err, 1e-6), (err, err_fused)


def _small_net(dtype, h0c_batch, fused, seed=5, b=2, ca=6):
    rng = np.random.default_rng(seed)
    r = lambda s, k=1.0: torch.from_numpy((k * rng.standard_normal(s)).astype(np.float32))  # noqa: E731
    total0 = 3 * 8 + 2 * ca
    wjs = [r((total0 - j * 8, 16 if j == 0 else 8, 3, 3), 0.1) for j in range(4)]
    args = [r((b, 8, 16, ca)), r((b, 8, 16, ca)), r((h0c_batch, 8, 16, 16), 0.5).to(dtype),
            r((16, ca, 3, 3), 0.2), r((16,), 0.1), wjs, r((total0,), 0.1)]
    return args, pack_net(*args[3:], dtype, fused=fused)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0c_batch", [1, 2])
def test_default_numerics_bit_equal_to_fused_at_f32(h0c_batch, reverse):
    """At f32 the default path's rounding is the identity: y, logdet and
    every gradient of the plain version equal the fused numerics' bit for
    bit, through the operator and through autograd."""
    outs = []
    for fused in (False, True):
        (xa, xb, h0c, win0, b0, wjs, bj0), net = _small_net(torch.float32, h0c_batch, fused)
        assert net.fused is fused
        y, ld = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
        y_op, ld_op = ops.fused_coupling(xa, xb, h0c, net, reverse=reverse)
        assert torch.equal(y_op, y) and torch.equal(ld_op, ld)
        leaves = [t.requires_grad_() for t in (xa, xb, h0c, win0, b0, bj0, *wjs)]
        ya, lda = fused_coupling_autograd(xa, xb, h0c, win0, b0, wjs, bj0, torch.float32,
                                          fused=fused, reverse=reverse)
        (ya.pow(2).sum() + lda.pow(2).sum()).backward()
        outs.append([y, ld, ya.detach(), lda.detach(), *[t.grad for t in leaves]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_numerics_gradients_match_jax(dtype, reverse):
    """Gradients of sum(y * c) + sum(logdet) through the port's coupling at
    ``use_pallas=False`` (autograd through K2's plain version, which rounds
    the cotangents where the forward rounds) against ``jax.grad`` of JAX's
    default path run eagerly, for x, the conditioning and every parameter,
    leaf by leaf, error relative to max(1, max|g|). f32: 1e-4. bf16: 5e-3
    (a cotangent may round one ulp apart), except the two biases, 0.1: a
    bias enters as ``bias.astype(bf16)``, so JAX sums its cotangent over
    B x H x W in bf16 (XLA's CPU reduces a bf16 sum in bf16), where the port
    sums in f32 and rounds once (measured here: 1.7e-2 and 4.9e-2). The
    fused numerics' gradients miss JAX's by more than 5e-3 on some other
    leaf (asserted)."""
    x, cond, jm, v, ports = _couplings(B, dtype, seed=10)
    c = _np(20, (B, H, W, C))

    def loss_j(params, x, cond):
        y, ld = jm.apply({**v, "params": params}, x, cond, reverse=reverse)
        return jnp.sum(y * c) + jnp.sum(ld)

    with jax.disable_jit():
        gp, gx, gc = jax.grad(loss_j, argnums=(0, 1, 2))(
            v["params"], jnp.asarray(x), jnp.asarray(cond))
    want = {**from_flax({**v, "params": jax.device_get(gp)}, ports[False]),
            "x": _t(gx), "cond": _t(gc)}
    errs = {}
    for use_pallas, m in ports.items():
        m.zero_grad(set_to_none=True)
        xt, ct = _t(x).requires_grad_(), _t(cond).requires_grad_()
        y, ld = m(xt, ct, reverse=reverse)
        (y * _t(c)).sum().add(ld.sum()).backward()
        got = {**{n: p.grad for n, p in m.named_parameters()}, "x": xt.grad, "cond": ct.grad}
        assert got.keys() == want.keys()
        errs[use_pallas] = {n: ((got[n] - w).abs().max() / max(1.0, w.abs().max())).item()
                            for n, w in want.items()}
    tol = 1e-4 if dtype == "float32" else 5e-3
    biases = {"net.conv_in_0.bias", "net.joint_0.bias"}
    assert biases <= want.keys()
    for name, err in errs[False].items():
        assert err <= (0.1 if dtype == "bfloat16" and name in biases else tol), (name, err)
    if dtype == "bfloat16":
        assert max(e for n, e in errs[True].items() if n not in biases) > tol, errs[True]


@pytest.mark.parametrize("h0c_batch", [1, 2])
def test_registered_op_carries_the_numerics(h0c_batch):
    """``tpuflow_torch::fused_coupling`` takes the numerics as an argument:
    at bf16 it equals the plain version of the same numerics bit for bit,
    both directions, and the two numerics differ."""
    outs = {}
    for fused in (False, True):
        (xa, xb, h0c, *_), net = _small_net(torch.bfloat16, h0c_batch, fused)
        for reverse in (False, True):
            y, ld = ops.fused_coupling(xa, xb, h0c, net, reverse=reverse)
            y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
            assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)
            outs[fused, reverse] = y
    assert not torch.equal(outs[False, False], outs[True, False])
    assert not torch.equal(outs[False, True], outs[True, True])


SMALL = dict(n_scales=2, n_flow_steps=2, hf_shape=(16, 32), lf_shape=(4, 8),
             coupling_width=16, coupling_layers=2, growth_rate=8, encoder_width=8,
             lstm_hidden=8, cond_channels=8, compute_dtype="bfloat16")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_use_pallas_reaches_every_coupling_call(monkeypatch, use_pallas):
    """``model.use_pallas`` from the case config reaches every coupling net
    and every call of K2's plain version on each path of the port: the
    rollout, the batched rollout, the member split, a training window
    (forward and backward), a fine-tune window and the exported rollout
    step (through the registered operator)."""
    from tpuflow_torch.data import NormStats
    from tpuflow_torch.tools.export_rollout import RolloutStep

    over = {f"model.{k}": (",".join(map(str, v)) if isinstance(v, tuple) else v)
            for k, v in SMALL.items()}
    cfg = load_case("backward-step", {**over, "model.use_pallas": use_pallas}).model
    assert cfg.use_pallas is use_pallas
    model = TMGlow(cfg, device="cpu", seed=0)
    perturb_(model, 1, scale=0.05)
    nets = [m for m in model.modules() if hasattr(m, "fused")]
    assert len(nets) == cfg.n_scales * cfg.n_flow_steps
    assert all(m.fused is use_pallas for m in nets)
    assert all(p.fused is use_pallas for row in model.glow.pack_couplings() for p in row)

    seen = []
    plain = tk.fused_coupling_reference

    def spy(xa, xb, h0c, net, *, reverse=False):
        seen.append(net.fused)
        return plain(xa, xb, h0c, net, reverse=reverse)

    monkeypatch.setattr(tk, "fused_coupling_reference", spy)
    per_step = cfg.n_scales * cfg.n_flow_steps
    gen = torch.Generator().manual_seed(2)
    lf = torch.randn(2, 4, 8, 3, generator=gen)
    hf = torch.randn(2, 2, 16, 32, 3, generator=gen)
    counts = {}

    def run(name, fn):
        seen.clear()
        fn()
        counts[name] = len(seen)
        assert seen and set(seen) == {use_pallas}, name

    with torch.no_grad():
        run("rollout", lambda: make_ensemble_rollout(model, 2, 0.5)(lf, generator=gen))
        run("batched", lambda: make_batched_ensemble_rollout(model, 2, 0.5)(
            lf[None].expand(2, -1, -1, -1, -1)))
        run("split", lambda: make_ensemble_rollout(
            model, 4, 0.5, mesh=make_mesh(1, 2, devices=["cpu", "cpu"]))(lf, generator=gen))
        step = RolloutStep(model, NormStats.from_data(np.ones((2, 4, 8, 3), np.float32),
                                                      np.ones((2, 16, 32, 3), np.float32)))
        feats = [f[:1] for f in model.encoder(lf)]
        state = init_lstm_state(cfg, 2, "cpu")
        eps = [torch.zeros(s) for s in latent_shapes(cfg, 2)]
        run("exported step", lambda: step(feats, state, eps, torch.full((cfg.n_scales,), 0.5)))

    def train():
        loss, _ = window_bpd_fn(model)(lf[None].expand(2, -1, -1, -1, -1)[:, :2], hf,
                                       init_lstm_state(cfg, 2, "cpu"))
        loss.backward()

    run("train", train)

    def finetune():
        eps = [[torch.randn(s, generator=gen) for s in latent_shapes(cfg, 4)] for _ in range(2)]
        spec = torch.stack([tft.converged_log_spectra(hf[i]) for i in range(2)])
        lt = torch.log(torch.tensor([0.8, 0.7])).requires_grad_()
        loss, _ = tft.make_finetune_loss(model, 2)(
            lt, lf[None].expand(2, -1, -1, -1, -1)[:, :2], hf, spec,
            init_lstm_state(cfg, 2, "cpu"), 0.5, 0.05, 0.3, eps)
        loss.backward()

    run("finetune", finetune)
    # Steps (x chunks of the split) x couplings; training and the fine-tune:
    # the forward and the backward's recompute of each timestep (the
    # fine-tune: its NLL forward and its members' reverse).
    assert counts["rollout"] == counts["batched"] == 2 * per_step
    assert counts["split"] == 2 * 2 * per_step and counts["exported step"] == per_step
    assert counts["train"] == 2 * 2 * per_step
    assert counts["finetune"] == 2 * 2 * 2 * per_step


_JAX_TRAIN = """
import contextlib, pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, "tools")
from bf16_gap import jax_fused_path
from tpuflow.configs.config import ModelConfig
from tpuflow.data import generate_case
from tpuflow.models import TMGlow, init_lstm_state
from tpuflow.eval.rollout import make_nll_eval
from tpuflow.train.step import make_optimizer, make_trajectory_train_step, window_bpd_fn
tiny, b, out_path = eval(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
lf0, hf0 = generate_case("backward-step", b, 3, (16, 32), (4, 8), 0, 3)
lf, hf = generate_case("backward-step", b, 5, (16, 32), (4, 8), 4, 3)
jm = TMGlow(ModelConfig(**tiny))
v0 = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(hf0[:, 0]),
                                     jnp.asarray(lf0[:, 0]), init_lstm_state(jm.cfg, (b,))))
rng = np.random.default_rng(3)
v = {**v0, "params": jax.tree.map(
    lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v0["params"])}
res = {"variables": jax.device_get(v), "lf": lf, "hf": hf}
tx = make_optimizer(5e-4, 0.995, 100.0)
args = (v["params"], v["buffers"], jnp.asarray(lf[:, :3]), jnp.asarray(hf[:, :3]),
        init_lstm_state(jm.cfg, (b,)))
(loss, _), g = jax.jit(jax.value_and_grad(window_bpd_fn(jm), has_aux=True))(*args)
_, _, met = jax.jit(make_trajectory_train_step(jm, tx, window=2))(
    v["params"], v["buffers"], tx.init(v["params"]), jnp.asarray(lf), jnp.asarray(hf))
res["default"] = {"loss": float(loss),
              "grad_norm": float(np.sqrt(sum(float(jnp.sum(jnp.square(x)))
                                             for x in jax.tree.leaves(g)))),
              "bpd_per_window": np.asarray(met["bpd_per_window"]),
              "step_grad_norm": float(met["grad_norm"]),
              "nll": np.asarray(jax.jit(make_nll_eval(jm))(v, jnp.asarray(lf), jnp.asarray(hf)))}
# The fused path's forward only: its custom_vjp has no bf16 backward on the CPU.
with jax_fused_path():
    jf = TMGlow(ModelConfig(use_pallas=True, **tiny))
    res["fused"] = {"loss": float(jax.jit(window_bpd_fn(jf))(*args)[0]),
                    "nll": np.asarray(jax.jit(make_nll_eval(jf))(v, jnp.asarray(lf),
                                                                 jnp.asarray(hf)))}
with open(out_path, "wb") as f:
    pickle.dump(res, f)
"""

TINY = dict(n_scales=2, n_flow_steps=2, channels=3, hf_shape=(16, 32), lf_shape=(4, 8),
            coupling_width=16, coupling_layers=2, growth_rate=8, encoder_width=8,
            lstm_hidden=8, cond_channels=8, compute_dtype="bfloat16", conv_layout="nhwc")


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_train") / "train.pkl"
    env = {**os.environ, "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX_TRAIN, repr(TINY), "2", str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_train(res, use_pallas):
    """The port's window loss and gradient norm, its trajectory step's bpd
    per window and mean gradient norm, and its held-out bits/dim per step
    and trajectory (``make_nll_eval``), on the JAX run's weights."""
    cfg = ModelConfig(**TINY, use_pallas=use_pallas)
    model = TMGlow(cfg, device="cpu")
    model.load_state_dict(from_flax(res["variables"], model))
    lf, hf = torch.from_numpy(res["lf"]), torch.from_numpy(res["hf"])
    with torch.no_grad():
        nll = make_nll_eval(model)(lf, hf).numpy()
    loss, _ = window_bpd_fn(model)(lf[:, :3], hf[:, :3], init_lstm_state(cfg, 2, "cpu"))
    loss.backward()
    grad_norm = torch.sqrt(sum(p.grad.double().pow(2).sum() for p in model.parameters()))
    opt, sched = make_optimizer(model.parameters(), 5e-4, 0.995)
    m = trajectory_train_step(model, opt, sched, 100.0, 2, lf, hf)
    return {"loss": loss.item(), "grad_norm": grad_norm.item(), "nll": nll,
            "bpd_per_window": m["bpd"].numpy(), "step_grad_norm": m["grad_norm"].mean().item()}


def test_bf16_training_matches_jax_default_path(jax_train):
    """A bf16 training window (B = 2, 3 steps, width 16), a trajectory step
    (two windows, one Adam step between them) and the held-out bits/dim of
    each of 5 steps x 2 trajectories at ``use_pallas: false``, against
    JAX's default path.

    The two round the same values at the same points, but a value whose
    f32 sum lies on a bf16 rounding boundary rounds one ulp apart in the
    two summation orders now and then; on a large head value that moves a
    step's bits/dim by up to 4e-4 relative (measured: 8 of these 10 steps
    agree to 5e-7, two to 3e-4 and 4e-4). Tolerances, relative: per step,
    the median 1e-5 and the largest 1e-3; the window's loss 1e-4; its
    gradient norm, the trajectory step's mean gradient norm 5e-4 and its
    bpd per window 1e-3 (Adam's first step moves every parameter by ~lr x
    sign(g), and a gradient near zero can take either sign). The fused
    numerics miss JAX's default path by more than these on the window's
    loss and the per-step median (asserted), so the check tells the two
    apart."""
    want, fused = jax_train["default"], jax_train["fused"]
    got = _port_train(jax_train, False)
    rel = lambda a, b: np.abs(np.asarray(a) - b) / np.abs(b)  # noqa: E731
    assert np.median(rel(got["nll"], want["nll"])) <= 1e-5, (got["nll"], want["nll"])
    assert rel(got["nll"], want["nll"]).max() <= 1e-3, (got["nll"], want["nll"])
    assert np.median(rel(fused["nll"], want["nll"])) > 1e-4, fused["nll"]
    assert rel(got["loss"], want["loss"]) <= 1e-4, (got["loss"], want["loss"])
    assert rel(fused["loss"], want["loss"]) > 1e-4, fused["loss"]
    assert rel(got["grad_norm"], want["grad_norm"]) <= 5e-4, (got, want)
    np.testing.assert_allclose(got["bpd_per_window"], want["bpd_per_window"], rtol=1e-3)
    assert rel(got["step_grad_norm"], want["step_grad_norm"]) <= 5e-4, (got, want)


def test_bf16_training_window_matches_jax_fused_path(jax_train):
    """The same window's loss and the per-step bits/dim at ``use_pallas:
    true`` against JAX's fused coupling (``xla_reference``): 2e-5 relative
    each (f32 sums: only a relu feature can round one ulp apart), and the
    loss farther than that from JAX's default path. Forward only: JAX's
    fused coupling has no bf16 backward on the CPU (its custom_vjp's
    backward stops on a bf16 / f32 dtype mismatch)."""
    model = TMGlow(ModelConfig(**TINY, use_pallas=True), device="cpu")
    model.load_state_dict(from_flax(jax_train["variables"], model))
    lf, hf = torch.from_numpy(jax_train["lf"]), torch.from_numpy(jax_train["hf"])
    with torch.no_grad():
        loss, _ = window_bpd_fn(model)(lf[:, :3], hf[:, :3],
                                       init_lstm_state(model.cfg, 2, "cpu"))
        nll = make_nll_eval(model)(lf, hf).numpy()
    np.testing.assert_allclose(nll, jax_train["fused"]["nll"], rtol=2e-5)
    want, default = jax_train["fused"]["loss"], jax_train["default"]["loss"]
    assert abs(loss.item() - want) <= 2e-5 * abs(want), (loss.item(), want)
    assert abs(loss.item() - default) > 2e-5 * abs(default), (loss.item(), default)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_step_is_the_eager_step_in_each_numerics(dtype):
    """The serving artifact's step (``torch.export`` of ``RolloutStep``)
    equals the eager step bit for bit on the CPU in each numerics, and
    ``program.json`` records them; at bf16 the two numerics' steps differ,
    at f32 they are bit-equal."""
    from tpuflow_torch.data import NormStats
    from tpuflow_torch.tools.export_rollout import RolloutStep, build_exported

    over = {f"model.{k}": (",".join(map(str, v)) if isinstance(v, tuple) else v)
            for k, v in {**SMALL, "compute_dtype": dtype}.items()}
    norm = NormStats.from_data(_np(30, (2, 4, 8, 3)), _np(31, (2, 16, 32, 3)))
    gen = torch.Generator().manual_seed(4)
    lf = torch.randn(3, 4, 8, 3, generator=gen)
    mc = load_case("backward-step", over).model
    eps = [torch.randn(s, generator=gen) for s in latent_shapes(mc, 2)]
    outs = {}
    for use_pallas in (False, True):
        cfg = load_case("backward-step", {**over, "model.use_pallas": use_pallas,
                                          "eval.rollout_steps": 3, "eval.n_samples": 2})
        model = TMGlow(cfg.model, device="cpu", seed=0)
        perturb_(model, 1, scale=0.05)
        _, step, program = build_exported(cfg, model, norm)
        assert program["use_pallas"] is use_pallas
        with torch.no_grad():
            feats = [f[:1] for f in model.encoder(lf)]
            state = init_lstm_state(cfg.model, 2, "cpu")
            tau = torch.full((cfg.model.n_scales,), 0.5)
            served = step.module()(feats, state, eps, tau)
            eager = RolloutStep(model, norm)(feats, state, eps, tau)
        for a, b in zip(jax.tree.leaves(served), jax.tree.leaves(eager)):
            assert torch.equal(a, b)
        outs[use_pallas] = eager[1]
    assert torch.equal(outs[False], outs[True]) == (dtype == "float32")


def test_default_numerics_share_of_values_a_summation_order_moves():
    """What the card's check of K2 against its plain version in default
    numerics relies on (``chip_smoke.py`` ``DEFAULT_SHARE_TOL``, the
    rollout-shape test of ``test_torch_cuda.py``): both round the head
    (raw, t) to bf16, so another f32 summation order (here f64 sums, each
    conv rounded to f32 once) moves y only where a sum lies on a rounding
    boundary: at most 2 % of the values of y by more than 1e-5 (full
    coupling width, scale 0, B = 2; the test prints the share), while a
    numerics that misses the rounding points (the fused one) moves more
    than 40 % (80 % of y_a; y_b is x_b); the card's bound, 10 %, lies
    between."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(1)
    b, h, w, ca, width, growth, L = 2, 32, 64, 6, 64, 32, 3
    total0 = L * growth + 2 * ca

    def lecun(cout, cin):
        return torch.randn(cout, cin, 3, 3, generator=gen) / np.sqrt(9 * cin)

    wjs = [lecun(total0 - j * growth, width if j == 0 else growth) for j in range(L + 1)]
    for wj in wjs:
        wj[-2 * ca:] *= 0.1
    args = (lecun(width, ca), 0.1 * torch.randn(width, generator=gen), wjs,
            0.1 * torch.randn(total0, generator=gen))
    xa, xb = torch.randn(b, h, w, ca, generator=gen), torch.randn(b, h, w, ca, generator=gen)
    h0c = (0.5 * torch.randn(b, h, w, width, generator=gen)).to(torch.bfloat16)
    ys = {}
    for fused in (False, True):
        ys[fused] = fused_coupling_reference(
            xa, xb, h0c, pack_net(*args, torch.bfloat16, fused=fused), reverse=True)[0]
    conv = F.conv2d
    try:
        F.conv2d = lambda x, k, padding: conv(x.double(), k.double(), padding=padding).float()
        y64 = fused_coupling_reference(
            xa, xb, h0c, pack_net(*args, torch.bfloat16, fused=False), reverse=True)[0]
    finally:
        F.conv2d = conv

    def share(a, b):
        return ((a - b).abs() > 1e-5).float().mean().item()

    assert 0 < share(y64, ys[False]) <= 0.02, share(y64, ys[False])
    assert share(ys[True], ys[False]) > 0.4, share(ys[True], ys[False])
    print(f"share moved: f64 sums {share(y64, ys[False]):.3e}, "
          f"fused numerics {share(ys[True], ys[False]):.3e}")


@pytest.mark.parametrize("ckpt_pallas", [False, True])
def test_loader_warns_when_the_config_is_not_the_checkpoints_numerics(tmp_path, capsys,
                                                                      ckpt_pallas):
    """``load_eval_bundle`` builds the model in the config's numerics and
    warns when the checkpoint's meta says it was trained in the other."""
    from tpuflow_torch.data import NormStats
    from tpuflow_torch.eval import load_eval_bundle
    from tpuflow_torch.train import Checkpointer

    over = {f"model.{k}": (",".join(map(str, v)) if isinstance(v, tuple) else v)
            for k, v in SMALL.items()}
    norm = NormStats(*(np.full(3, v, np.float32) for v in (0.1, 2.0, -0.5, 3.0)))
    Checkpointer(tmp_path / "backward-step").save(1, {
        "model": TMGlow(load_case("backward-step", over).model, device="cpu").state_dict(),
        "norm": {k: torch.from_numpy(v) for k, v in norm.to_dict().items()},
        "meta": {"config": {"model": {"use_pallas": ckpt_pallas}}}})
    for use_pallas in (False, True):
        cfg = load_case("backward-step", {**over, "train.checkpoint_dir": str(tmp_path),
                                          "model.use_pallas": use_pallas})
        model, _, _ = load_eval_bundle(cfg, device="cpu")
        assert all(p.fused is use_pallas for row in model.glow.pack_couplings() for p in row)
        warned = "WARNING: checkpoint was trained with model.use_pallas" in capsys.readouterr().out
        assert warned == (use_pallas != ckpt_pallas)
