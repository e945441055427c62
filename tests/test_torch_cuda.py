"""The port's CUDA kernels on the card: the fused coupling (K2) against its
plain version, the wrapper's refusals, a small rollout through the
kernel against the same rollout on the CPU, K2 under autograd and a
training window against the CPU; the coupling apply (K1) against its
plain version, forward, reverse, gradients and determinism.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere (the CUDA
kernel has no CPU or interpret mode). This file imports neither JAX nor
the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)

Tolerances, kernel against plain version on the same card and inputs:
at float32 y 2e-5 and logdet 2e-4, as the JAX package's own
fused-kernel tests (both accumulate in f32; only the summation order
differs). At bfloat16 y 5e-3 and logdet 0.05 (``tests/test_kernels.py``
uses 0.05 for both): both round the same inputs and weights to bf16 and
accumulate in f32, but a relu feature whose f32 sum lies near a bf16
rounding boundary can round one ulp apart in the two summation orders.
K1: the JAX package's tolerances (y 1e-6, logdet 1e-5, gradients 1e-5,
each plus the same relative term), as its Pallas tests use.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.configs import ModelConfig, load_case
from tpuflow_torch.device import resolve_device
from tpuflow_torch.eval import make_ensemble_rollout
from tpuflow_torch.kernels import coupling_apply as ka
from tpuflow_torch.kernels import coupling_fused as tk
from tpuflow_torch.kernels.coupling_apply import coupling_apply, coupling_apply_reference
from tpuflow_torch.kernels.coupling_fused import (
    fused_coupling,
    fused_coupling_autograd,
    fused_coupling_reference,
    pack_net,
)
from tpuflow_torch.models import TMGlow, init_lstm_state, scale_shapes
from tpuflow_torch.train import Trainer, window_bpd_fn

torch.set_num_threads(1)

WIDTH, GROWTH, LAYERS = 16, 8, 3
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (5e-3, 0.05)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return resolve_device("cuda")


def _np(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _case(dtype, device, b=3, h=8, w=16, ca=6, h0c_batch=1, seed=0):
    """Inputs and packed weights, with a non-zero head so the coupling
    is not a constant scale."""
    rng = np.random.default_rng(seed)
    total0 = LAYERS * GROWTH + 2 * ca
    wjs = [_np(rng, (total0 - j * GROWTH, WIDTH if j == 0 else GROWTH, 3, 3), 0.1)
           for j in range(LAYERS + 1)]
    net = pack_net(_np(rng, (WIDTH, ca, 3, 3), 0.2).to(device), _np(rng, (WIDTH,), 0.1).to(device),
                   [wj.to(device) for wj in wjs], _np(rng, (total0,), 0.1).to(device), dtype)
    xa = _np(rng, (b, h, w, ca)).to(device)
    xb = _np(rng, (b, h, w, ca)).to(device)
    h0c = None if h0c_batch is None else _np(rng, (h0c_batch, h, w, WIDTH), 0.5).to(device, dtype)
    return xa, xb, h0c, net


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0c_batch", [None, 1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, h0c_batch, reverse):
    tol_y, tol_ld = _TOL[dtype]
    xa, xb, h0c, net = _case(_DT[dtype], cuda_device, h0c_batch=h0c_batch)
    before = tk.launches
    y, ld = fused_coupling(xa, xb, h0c, net, reverse=reverse)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
    torch.testing.assert_close(y, y_ref, atol=tol_y, rtol=1e-5)
    torch.testing.assert_close(ld, ld_ref, atol=tol_ld, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    xa, xb, h0c, net = _case(torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fused_coupling(xa.transpose(1, 2), xb, h0c, net)
    with pytest.raises(TypeError, match="h0c"):
        fused_coupling(xa, xb, h0c.to(torch.bfloat16), net)
    with pytest.raises(ValueError, match="requires grad"):
        fused_coupling(xa.requires_grad_(), xb, h0c, net)


@pytest.mark.cuda
def test_cuda_rollout_matches_cpu(cuda_device):
    """A small f32 rollout through the kernel on the card against the
    plain version on the CPU, same weights and draws (1e-4: the reverse
    flow carries summation-order differences through 2 scales x 2 steps
    x 3 timesteps)."""
    cfg = ModelConfig(n_scales=2, n_flow_steps=2, hf_shape=(16, 32), lf_shape=(4, 8),
                      coupling_width=16, coupling_layers=2, growth_rate=8, encoder_width=8,
                      lstm_hidden=8, cond_channels=8, compute_dtype="float32")
    cpu = TMGlow(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    gpu = TMGlow(cfg, device=cuda_device, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    n, steps = 4, 3
    lf = torch.randn(steps, 4, 8, 3, generator=gen)
    eps, c = [], cfg.channels
    for l, (h, w) in enumerate(scale_shapes(cfg)):
        c *= 4
        ch = c // 2 if l < cfg.n_scales - 1 else c
        eps.append((n, h, w, ch))
        c = ch
    eps = [[torch.randn(s, generator=gen) for s in eps] for _ in range(steps)]
    want = make_ensemble_rollout(cpu, n, 0.85, "fields")(lf, eps=eps)
    before = tk.launches
    got = make_ensemble_rollout(gpu, n, 0.85, "fields")(
        lf.to(cuda_device), eps=[[e.to(cuda_device) for e in row] for row in eps])
    assert tk.launches - before == steps * cfg.n_scales * cfg.n_flow_steps
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


SMALL = dict(n_scales=2, n_flow_steps=2, hf_shape=(16, 32), lf_shape=(4, 8),
             coupling_width=16, coupling_layers=2, growth_rate=8, encoder_width=8,
             lstm_hidden=8, cond_channels=8, compute_dtype="float32")


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_k2_autograd_matches_cpu(cuda_device, reverse):
    """K2 under autograd on the card (kernel forward, plain recompute
    backward) against the same Function on the CPU, every input's
    gradient: 1e-4 x max(1, max|g|) (the forwards' summation order)."""
    rng = np.random.default_rng(1)
    ca, total0 = 6, LAYERS * GROWTH + 12
    cpu = [_np(rng, (3, 8, 16, ca)), _np(rng, (3, 8, 16, ca)), _np(rng, (1, 8, 16, WIDTH), 0.5),
           _np(rng, (WIDTH, ca, 3, 3), 0.2), _np(rng, (WIDTH,), 0.1),
           _np(rng, (total0,), 0.1)]
    wjs = [_np(rng, (total0 - j * GROWTH, WIDTH if j == 0 else GROWTH, 3, 3), 0.1)
           for j in range(LAYERS + 1)]
    grads = []
    for dev in ("cpu", cuda_device):
        xa, xb, h0c, win0, b0, bj0 = [a.detach().to(dev).requires_grad_() for a in cpu]
        ws = [w.detach().to(dev).requires_grad_() for w in wjs]
        before = tk.launches
        y, ld = fused_coupling_autograd(xa, xb, h0c, win0, b0, ws, bj0, torch.float32,
                                        reverse=reverse)
        (y.pow(2).sum() + ld.pow(2).sum()).backward()
        assert tk.launches - before == (1 if dev != "cpu" else 0)
        grads.append([a.grad.cpu() for a in (xa, xb, h0c, win0, b0, bj0, *ws)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, b.abs().max().item()), rtol=0)


@pytest.mark.cuda
def test_cuda_training_window_matches_cpu(cuda_device):
    """One f32 window through the kernel on the card against the plain
    version on the CPU, same weights and data: loss 1e-5 relative, every
    gradient 1e-4 x max(1, max|g|)."""
    cfg = ModelConfig(**SMALL)
    cpu = TMGlow(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(2)
    lf, hf = _np(rng, (2, 3, 4, 8, 3)), _np(rng, (2, 3, 16, 32, 3))
    cpu.data_init(hf[:, 0], lf[:, 0], init_lstm_state(cfg, 2, "cpu"))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    gpu = TMGlow(cfg, device=cuda_device, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    out = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        before = tk.launches
        loss, _ = window_bpd_fn(m)(lf.to(dev), hf.to(dev), init_lstm_state(cfg, 2, dev))
        loss.backward()
        if dev != "cpu":
            assert tk.launches - before == 3 * cfg.n_scales * cfg.n_flow_steps
        out.append((loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()}))
    (l_c, g_c), (l_g, g_g) = out
    assert abs(l_g - l_c) <= 1e-5 * max(1.0, abs(l_c))
    for n, g in g_c.items():
        torch.testing.assert_close(g_g[n], g, atol=1e-4 * max(1.0, g.abs().max().item()),
                                   rtol=0, msg=n)


@pytest.mark.cuda
def test_cuda_trainer_launches_k2_and_resumes(cuda_device, tmp_path):
    over = {f"model.{k}": (",".join(map(str, v)) if isinstance(v, tuple) else v)
            for k, v in SMALL.items()}
    over.update({"data.n_train_traj": 2, "data.train_steps": 4, "data.batch_size": 2,
                 "data.window": 2, "train.epochs": 1, "train.checkpoint_dir": str(tmp_path)})
    before = tk.launches
    t = Trainer(load_case("backward-step", over), device="cuda")
    out = t.run()
    per_step = 2 * 2
    assert tk.launches - before == per_step * (1 + 2 * 2)
    assert out["epoch"] == 1 and np.isfinite(out["mean_bpd"])
    over["train.epochs"] = 2
    t2 = Trainer(load_case("backward-step", over), device="cuda")
    t2.init_or_resume()
    assert t2.epoch == 1
    assert t2.run()["epoch"] == 2


K1_SHAPES = [(2, 4, 4, 4), (3, 5, 7, 3), (2, 2, 8, 16, 2), (64, 32, 64, 6)]


def _k1_inputs(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    return [_np(rng, shape, s).to(device) for s in (1.0, 0.5, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_cuda_k1_matches_plain_version(cuda_device, shape, reverse):
    x, raw, t = _k1_inputs(shape, cuda_device)
    before = ka.launches
    y, ld = coupling_apply(x, raw, t, reverse=reverse)
    torch.cuda.synchronize()
    assert ka.launches == before + 1 and ld.shape == shape[:-3]
    y_ref, ld_ref = coupling_apply_reference(x, raw, t, reverse=reverse)
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ld, ld_ref, atol=1e-5, rtol=1e-6)
    y2, ld2 = coupling_apply(x, raw, t, reverse=reverse)
    assert torch.equal(y, y2) and torch.equal(ld, ld2)  # fixed summation order


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_k1_gradients_roundtrip_and_hwnc(cuda_device, reverse):
    grads = []
    for fn in (coupling_apply, coupling_apply_reference):
        xs = [a.requires_grad_() for a in _k1_inputs((3, 5, 7, 3), cuda_device, 1)]
        y, ld = fn(*xs, reverse=reverse)
        (y.pow(2).sum() + 0.5 * ld.pow(2).sum()).backward()
        grads.append([a.grad for a in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    x, raw, t = _k1_inputs((2, 4, 6, 4), cuda_device, 2)
    y, ld_f = coupling_apply(x, raw, t)
    x_rec, ld_r = coupling_apply(y, raw, t, reverse=True)
    torch.testing.assert_close(x_rec, x, atol=1e-5, rtol=0)
    torch.testing.assert_close(ld_f, -ld_r, atol=1e-6, rtol=1e-6)
    x, raw, t = _k1_inputs((4, 6, 3, 2), cuda_device, 3)
    before = ka.launches
    y, ld = coupling_apply(x, raw, t, reverse=reverse, layout="hwnc")
    assert ka.launches == before + 1
    y_ref, ld_ref = coupling_apply_reference(x, raw, t, reverse=reverse, layout="hwnc")
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ld, ld_ref, atol=1e-5, rtol=1e-6)
