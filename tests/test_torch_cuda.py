"""The port's CUDA kernels on the card: the fused coupling (K2) against its
plain version (at the evaluator's batch of 256 too), the wrapper's
refusals, a small rollout through the kernel against the same rollout on
the CPU, the batched rollout against a loop of single-trajectory
rollouts, K2 under autograd and a training window against the CPU; the
fine-tune (K2 forward and reverse under autograd, at the members' batch
too) against the CPU and with remat against without; the coupling apply
(K1) against its plain version, forward, reverse, gradients and
determinism; the member split of the rollout over a mesh of two entries
on the one card, and over two cards where the host has them, against the
flat rollout; a streamed .tpf batch uploaded
to the card against the RAM batch; K2 through its registered operator
(``tpuflow_torch::fused_coupling``) bit-equal to the wrapper's launch, and
a served artifact (``torch.export`` of the encoder and one step, exported
on the card) against the rollout on the same seeded generator.

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

The evaluator's statistics and calibration maps (``eval/stats.py``,
``eval/calibrate.py``) on CUDA tensors against the same functions on the
CPU: 1e-5 relative, 1e-6 absolute near 0; histogram counts exact.
"""

import shutil

import numpy as np
import pytest
import torch

from tpuflow_torch.configs import ModelConfig, load_case
from tpuflow_torch.device import resolve_device
from tpuflow_torch.eval import calibrate as tcal
from tpuflow_torch.eval import make_batched_ensemble_rollout, make_ensemble_rollout
from tpuflow_torch.eval import stats as tstats
from tpuflow_torch.kernels import coupling_apply as ka
from tpuflow_torch.kernels import coupling_fused as tk
from tpuflow_torch.kernels.coupling_apply import coupling_apply, coupling_apply_reference
from tpuflow_torch.kernels.coupling_fused import (
    fused_coupling,
    fused_coupling_autograd,
    fused_coupling_reference,
    pack_net,
)
from tpuflow_torch.models import TMGlow, init_lstm_state, latent_shapes, perturb_
from tpuflow_torch.train import Trainer, window_bpd_fn
from tpuflow_torch.train import finetune as tft

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


def _lecun_case(device, dtype, b, h, w, ca, cb, width, growth, layers, h0c_batch, seed):
    """Inputs and packed weights at lecun scale (kernels / sqrt(9 cin), the
    head columns x 0.1), so the features stay O(1) at any width."""
    rng = np.random.default_rng(seed)
    total0 = layers * growth + 2 * ca

    def lecun(cout, cin):
        wt = _np(rng, (cout, cin, 3, 3), 1.0 / (9 * cin) ** 0.5)
        wt[-2 * ca:] *= 0.1
        return wt.to(device)

    net = pack_net(lecun(width, cb), _np(rng, (width,), 0.1).to(device),
                   [lecun(total0 - j * growth, width if j == 0 else growth)
                    for j in range(layers + 1)],
                   _np(rng, (total0,), 0.1).to(device), dtype)
    xa, xb = _np(rng, (b, h, w, ca)).to(device), _np(rng, (b, h, w, cb)).to(device)
    h0c = None
    if h0c_batch is not None:
        h0c = _np(rng, (b if h0c_batch == "B" else 1, h, w, width), 0.5).to(device, dtype)
    return xa, xb, h0c, net


# (b, h, w, ca, cb, width, growth, layers): the bf16 tensor-core kernel's
# edges. ca = 1 with cb = 2 (the C = 3 probe); growth 8 / width 16; the
# coupling_width=128 preset at scale 1; W = 128 (the widest row); H = 7,
# W = 24 (a partial last tile, 120-pixel tiles that are not a multiple of a
# warp's 64); B = 1; scale 2 at B = 64 (tiles of half a member); one
# layer-free net (L = 0: joint_0 is the last layer); width 12 and growth 5
# (feature rows copied in part-filled 16-byte chunks, the relu boundary
# inside a fragment's column pair, running sums shifted by an odd number
# of columns, h0c read without its tile); the cylinder-array preset's
# three scales at its 4 members (48 x 48 / 24 x 24 / 12 x 12 planes: tiles
# of 2 / 5 / 6 rows, scale 1's last tile part-filled, 96 / 120 / 72 live
# pixels in 128-row warp tiles).
EDGE_SHAPES = [
    (2, 8, 16, 1, 2, 16, 8, 3),
    (3, 8, 16, 6, 6, 16, 8, 3),
    (4, 16, 32, 12, 12, 128, 32, 3),
    (2, 4, 128, 6, 6, 64, 32, 3),
    (3, 7, 24, 5, 5, 64, 32, 3),
    (1, 32, 64, 6, 6, 64, 32, 3),
    (64, 8, 16, 24, 24, 64, 32, 3),
    (2, 8, 16, 6, 6, 16, 8, 0),
    (2, 8, 16, 3, 3, 12, 5, 2),
    (4, 48, 48, 6, 6, 64, 32, 3),
    (4, 24, 24, 12, 12, 64, 32, 3),
    (4, 12, 12, 24, 24, 64, 32, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0c_batch", [None, 1, "B"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_edge_shapes(cuda_device, shape, dtype, h0c_batch, reverse):
    """Both kernels against the plain version at the edges of the bf16
    kernel's tile plan, and the logdet (and y) bit-identical over two
    launches (fixed summation order, no atomics)."""
    b, h, w, ca, cb, width, growth, layers = shape
    if shape == EDGE_SHAPES[6]:
        assert tk.tile_plan(b, h, w, width, layers * growth + 2 * ca).rows * 2 == h
    if shape == EDGE_SHAPES[10]:
        assert h % tk.tile_plan(b, h, w, width, layers * growth + 2 * ca).rows != 0
    _check_against_plain(cuda_device, shape, dtype, h0c_batch, reverse)


# The evaluator's batched rollout: traj_batch 4 x 64 members = B 256 at the
# backward-step preset's three scales.
EVAL_SHAPES = [(256, 32, 64, 6, 6, 64, 32, 3), (256, 16, 32, 12, 12, 64, 32, 3),
               (256, 8, 16, 24, 24, 64, 32, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0c_batch", [1, "B"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EVAL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_at_the_evaluator_batch(cuda_device, shape, dtype, h0c_batch, reverse):
    _check_against_plain(cuda_device, shape, dtype, h0c_batch, reverse)


def _check_against_plain(cuda_device, shape, dtype, h0c_batch, reverse):
    b, h, w, ca, cb, width, growth, layers = shape
    tol_y, tol_ld = _TOL[dtype]
    xa, xb, h0c, net = _lecun_case(cuda_device, _DT[dtype], *shape, h0c_batch, seed=sum(shape))
    before = tk.launches
    y, ld = fused_coupling(xa, xb, h0c, net, reverse=reverse)
    y2, ld2 = fused_coupling(xa, xb, h0c, net, reverse=reverse)
    torch.cuda.synchronize()
    assert tk.launches == before + 2
    assert torch.equal(ld, ld2) and torch.equal(y, y2)
    y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
    assert y.shape == (b, h, w, ca + cb) and torch.isfinite(y).all()
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
    eps = [[torch.randn(s, generator=gen) for s in latent_shapes(cfg, n)] for _ in range(steps)]
    want = make_ensemble_rollout(cpu, n, 0.85, "fields")(lf, eps=eps)
    before = tk.launches
    got = make_ensemble_rollout(gpu, n, 0.85, "fields")(
        lf.to(cuda_device), eps=[[e.to(cuda_device) for e in row] for row in eps])
    assert tk.launches - before == steps * cfg.n_scales * cfg.n_flow_steps
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_batched_rollout_matches_loop(cuda_device):
    """The batched rollout (3 trajectories x 4 members as one batch of 12
    through the kernel) against a loop of single-trajectory rollouts on
    the card with the same draws: 1e-4 x max(1, max |ref|) (the batch
    changes cuDNN's choice of conditioning convs)."""
    cfg = ModelConfig(n_scales=2, n_flow_steps=2, hf_shape=(16, 32), lf_shape=(4, 8),
                      coupling_width=16, coupling_layers=2, growth_rate=8, encoder_width=8,
                      lstm_hidden=8, cond_channels=8, compute_dtype="float32")
    model = TMGlow(cfg, device=cuda_device, seed=0)
    perturb_(model, 1, scale=0.05)
    b, n, steps = 3, 4, 3
    gen = torch.Generator().manual_seed(2)
    lfs = torch.randn(b, steps, 4, 8, 3, generator=gen).to(cuda_device)
    eps = [[[torch.randn(s, generator=gen).to(cuda_device) for s in latent_shapes(cfg, n)]
            for _ in range(steps)] for _ in range(b)]
    before = tk.launches
    got = make_batched_ensemble_rollout(model, n, 0.85)(lfs, eps=eps)
    assert tk.launches - before == steps * cfg.n_scales * cfg.n_flow_steps
    single = make_ensemble_rollout(model, n, 0.85)
    for i in range(b):
        want = single(lfs[i], eps=eps[i])
        for k in ("mean", "var"):
            tol = 1e-4 * max(1.0, want[k].abs().max().item())
            torch.testing.assert_close(got[k][i], want[k], atol=tol, rtol=0)


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


@pytest.mark.cuda
def test_cuda_k2_reverse_autograd_at_member_batch(cuda_device):
    """K2 in reverse under autograd at B = 24, the fine-tune's members
    (4 trajectories x 6), the conditioning batched 24, on the card
    against the CPU: every input's gradient 1e-4 x max(1, max|g|)."""
    rng = np.random.default_rng(4)
    ca, total0, b = 6, LAYERS * GROWTH + 12, 24
    cpu = [_np(rng, (b, 8, 16, ca)), _np(rng, (b, 8, 16, ca)), _np(rng, (b, 8, 16, WIDTH), 0.5),
           _np(rng, (WIDTH, ca, 3, 3), 0.2), _np(rng, (WIDTH,), 0.1), _np(rng, (total0,), 0.1)]
    wjs = [_np(rng, (total0 - j * GROWTH, WIDTH if j == 0 else GROWTH, 3, 3), 0.1)
           for j in range(LAYERS + 1)]
    grads = []
    for dev in ("cpu", cuda_device):
        xa, xb, h0c, win0, b0, bj0 = [a.detach().to(dev).requires_grad_() for a in cpu]
        ws = [w.detach().to(dev).requires_grad_() for w in wjs]
        before = tk.launches
        y, ld = fused_coupling_autograd(xa, xb, h0c, win0, b0, ws, bj0, torch.float32,
                                        reverse=True)
        (y.pow(2).sum() + ld.pow(2).sum()).backward()
        assert tk.launches - before == (1 if dev != "cpu" else 0)
        grads.append([a.grad.cpu() for a in (xa, xb, h0c, win0, b0, bj0, *ws)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, b.abs().max().item()), rtol=0)


def _finetune_window(model, dev, remat=False, m=3):
    """One fine-tune window (B = 2, W = 2, M = m, every lambda nonzero)
    with draws made on the CPU: (loss, {name: grad} with log_tau's)."""
    cfg = model.cfg
    rng = np.random.default_rng(5)
    lf, hf = _np(rng, (2, 2, 4, 8, 3)), _np(rng, (2, 2, 16, 32, 3))
    spec = torch.stack([tft.converged_log_spectra(hf[i]) for i in range(2)])
    gen = torch.Generator().manual_seed(6)
    eps = [[torch.randn(s, generator=gen).to(dev) for s in latent_shapes(cfg, 2 * m)]
           for _ in range(2)]
    lt = torch.log(torch.tensor([0.8, 0.7], device=dev)).requires_grad_()
    model.zero_grad(set_to_none=True)
    loss, _ = tft.make_finetune_loss(model, m, remat)(
        lt, lf.to(dev), hf.to(dev), spec.to(dev), init_lstm_state(cfg, 2, dev), 0.5, 0.05, 0.3,
        eps)
    loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    grads["log_tau"] = lt.grad.cpu()
    return loss.item(), grads


def _small_pair(dev):
    cfg = ModelConfig(**SMALL)
    cpu = TMGlow(cfg, device="cpu", seed=0)
    perturb_(cpu, 7, 0.05)
    gpu = TMGlow(cfg, device=dev, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


@pytest.mark.cuda
def test_cuda_finetune_window_matches_cpu(cuda_device):
    """One f32 fine-tune window through K2 (forward at B = 2, reverse at
    B x M = 6, both under autograd) on the card against the plain version
    on the CPU, same weights and draws: loss 1e-5 relative, every
    gradient and log_tau's 1e-4 x max(1, max|g|)."""
    cpu, gpu = _small_pair(cuda_device)
    l_c, g_c = _finetune_window(cpu, "cpu")
    before = tk.launches
    l_g, g_g = _finetune_window(gpu, cuda_device)
    per_step = 2 * 2
    assert tk.launches - before == 2 * 2 * per_step  # 2 timesteps x (forward + reverse)
    assert np.isfinite(l_c) and abs(l_g - l_c) <= 1e-5 * max(1.0, abs(l_c))
    for n, g in g_c.items():
        torch.testing.assert_close(g_g[n], g, atol=1e-4 * max(1.0, g.abs().max().item()),
                                   rtol=0, msg=n)


@pytest.mark.cuda
def test_cuda_remat_matches_no_remat(cuda_device):
    """remat on the card: the same fine-tune loss (1e-6 relative) and
    gradients (1e-6 x max(1, max|g|)) as without it; each timestep's K2
    launches run again in the recompute."""
    _, gpu = _small_pair(cuda_device)
    out = []
    for remat in (False, True):
        before = tk.launches
        out.append((*_finetune_window(gpu, cuda_device, remat), tk.launches - before))
    (l0, g0, n0), (l1, g1, n1) = out
    assert n1 == 2 * n0 == 32
    assert abs(l1 - l0) <= 1e-6 * max(1.0, abs(l0))
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, atol=1e-6 * max(1.0, g.abs().max().item()),
                                   rtol=0, msg=n)


# The JAX package's test shapes, the flagship shape; D % 4 of 1, 2 and 3
# (rows that start off a 16-byte boundary: scalar head and tail), D = 1,
# one row of 2^19 (the full cluster) and 70,000 rows (past the 65,535 a
# grid's y may hold).
K1_SHAPES = [(2, 4, 4, 4), (3, 5, 7, 3), (2, 2, 8, 16, 2), (64, 32, 64, 6),
             (3, 3, 3, 1), (2, 3, 5, 2), (2, 1, 1, 7), (1, 1, 1, 1), (1, 256, 512, 4),
             (70000, 1, 1, 4)]


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


def _at_offset(a, offset):
    """A copy of ``a`` in a view that starts ``offset`` floats into its
    storage, off a 16-byte boundary."""
    view = torch.empty(a.numel() + offset, device=a.device)[offset:].view(a.shape)
    view.copy_(a)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", ["x_offset", "raw_t_offset", "hwnc", "hwnc_x_offset"])
def test_cuda_k1_storage_offsets_and_hwnc(cuda_device, case, reverse):
    """Inputs that start off a 16-byte boundary (storage-offset views) and
    the hwnc layout: each call launches the kernel once, matches the plain
    version and is bit-identical over two launches."""
    layout = "hwnc" if case.startswith("hwnc") else "nhwc"
    x, raw, t = _k1_inputs((4, 6, 3, 5) if layout == "hwnc" else (3, 5, 7, 3), cuda_device, 4)
    if case in ("x_offset", "hwnc_x_offset"):
        x = _at_offset(x, 1)
    if case == "raw_t_offset":
        raw, t = _at_offset(raw, 2), _at_offset(t, 3)
    outs = []
    for _ in range(2):
        before = ka.launches
        outs.append(coupling_apply(x, raw, t, reverse=reverse, layout=layout))
        torch.cuda.synchronize()
        assert ka.launches == before + 1
    y_ref, ld_ref = coupling_apply_reference(x, raw, t, reverse=reverse, layout=layout)
    (y, ld), (y2, ld2) = outs
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ld, ld_ref, atol=1e-5, rtol=1e-6)
    assert torch.equal(y, y2) and torch.equal(ld, ld2)


def _on_both(cuda_device, fn, *args, **kw):
    """fn on CUDA copies of the tensor arguments and on the CPU ones."""
    dev = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args]
    return fn(*dev, **kw), fn(*args, **kw)


def _close_cpu(got, want, rtol=1e-5, atol=1e-6):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        assert g.is_cuda
        torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("taper", [False, True])
@pytest.mark.parametrize("domain", [None, (1.0, 4.0)])
def test_cuda_energy_spectrum_matches_cpu(cuda_device, taper, domain):
    x = _np(np.random.default_rng(90), (64, 8, 64, 128, 2))
    _close_cpu(*_on_both(cuda_device, tstats.energy_spectrum, x, domain, taper))


@pytest.mark.cuda
@pytest.mark.parametrize("bins,lo,hi", [(64, -3.0, 3.0), (10, 0.0, 1.0)])
def test_cuda_histogram_matches_cpu(cuda_device, bins, lo, hi):
    """Counts exact, values on the edges included."""
    x = torch.cat([_np(np.random.default_rng(91), (1 << 20,)),
                   tstats.histogram(torch.zeros(1), bins, lo, hi)[1]])
    (gd, ge, gc), (cd, ce, cc) = _on_both(cuda_device, tstats.histogram, x, bins, lo, hi)
    assert torch.equal(ge.cpu(), ce) and torch.equal(gc.cpu(), cc)
    _close_cpu(gd, cd)
    _close_cpu(*_on_both(cuda_device, tstats.fluctuation_pdf, x))


@pytest.mark.cuda
def test_cuda_large_quantile_matches_cpu(cuda_device):
    """Above 2^24 values (torch.quantile's limit): the evaluator's W1 pools
    64 members x 32 steps x 64 x 128 = 2^24 values per channel."""
    x = _np(np.random.default_rng(92), (2**24 + 3,))
    q = [0.0, 1e-7, 0.25, 0.5, 0.9, 1.0]
    _close_cpu(*_on_both(cuda_device, tstats.quantile, x, q))
    b = _np(np.random.default_rng(93), (4096,), 1.3)
    _close_cpu(*_on_both(cuda_device, tstats.wasserstein1, x, b))


@pytest.mark.cuda
def test_cuda_crps_and_coverage_match_cpu(cuda_device):
    rng = np.random.default_rng(94)
    members, ref = _np(rng, (64, 4, 64, 128, 3)), _np(rng, (4, 64, 128, 3), 1.5)
    _close_cpu(*_on_both(cuda_device, tstats.ensemble_crps, members, ref))
    _close_cpu(*_on_both(cuda_device, tstats.ensemble_coverage, members, ref))


@pytest.mark.cuda
def test_cuda_stratified_quantile_map_matches_cpu(cuda_device):
    rng = np.random.default_rng(95)
    pred, ref = _np(rng, (128, 20000), 1.2), _np(rng, (128, 5000), 0.9)
    fit_g, fit_c = _on_both(cuda_device, tcal.fit_quantile_map_stratified, pred, ref)
    _close_cpu(fit_g, fit_c)
    vals = _np(rng, (128, 64, 8, 64), 2.0)
    got = tcal.apply_quantile_map_stratified(vals.to(cuda_device), *fit_g)
    _close_cpu(got, tcal.apply_quantile_map_stratified(vals, *fit_c), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("collect", ["stats", "fields"])
def test_cuda_split_rollout_matches_flat(cuda_device, collect):
    """The member split over a mesh of [cuda, cuda] (two chunks, the second
    on a replica) against the flat rollout on one generator, both through
    K2: the same draws reach the same members, and only the chunks' batch
    sizes differ, 1e-5 x max(1, max |ref|) at f32."""
    from tpuflow_torch.train.mesh import make_mesh

    model = TMGlow(ModelConfig(**SMALL), device=cuda_device, seed=0)
    perturb_(model, 1, scale=0.05)
    n, steps = 8, 3
    lf = torch.randn(steps, 4, 8, 3, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    mesh = make_mesh(1, 2, devices=[cuda_device, cuda_device])
    split = make_ensemble_rollout(model, n, 0.85, collect, mesh=mesh)
    flat = make_ensemble_rollout(model, n, 0.85, collect)
    before = tk.launches
    got = split(lf, torch.Generator(cuda_device).manual_seed(4))
    assert tk.launches - before == 2 * steps * SMALL["n_scales"] * SMALL["n_flow_steps"]
    want = flat(lf, torch.Generator(cuda_device).manual_seed(4))
    pairs = [(got, want)] if collect == "fields" else [(got[k], want[k]) for k in want]
    for g, w in pairs:
        assert g.device == w.device and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * max(1.0, w.abs().max().item()))


@pytest.mark.cuda
def test_cuda_split_rollout_over_two_cards(cuda_device):
    """The member split over two cards at the backward-step preset's full
    width, bf16 (K2's shared memory above 48 KB must be allowed on each
    card it launches on), against the flat rollout on one generator: 5e-3
    x max(1, max |ref|), the bf16 tolerance."""
    from tpuflow_torch.train.mesh import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: the split over two cards")
    cfg = load_case("backward-step").model
    model = TMGlow(cfg, device=torch.device("cuda", 0), seed=0)
    perturb_(model, 1)
    lf = torch.randn(2, *cfg.lf_shape, cfg.channels,
                     generator=torch.Generator().manual_seed(3)).to(model.device)
    devices = [torch.device("cuda", i) for i in range(2)]
    split = make_ensemble_rollout(model, 8, 0.85, mesh=make_mesh(1, 2, devices=devices))
    flat = make_ensemble_rollout(model, 8, 0.85)
    got = split(lf, torch.Generator(model.device).manual_seed(4))
    want = flat(lf, torch.Generator(model.device).manual_seed(4))
    for k in want:
        assert bool(torch.isfinite(got[k]).all())
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=5e-3 * max(1.0, want[k].abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("use_native", [True, False])
def test_cuda_tpf_batch_on_the_card_equals_ram(cuda_device, tmp_path, use_native):
    """A streamed batch uploaded to the card is the RAM batch, bit for bit
    where the normalization's stds are powers of two."""
    from tpuflow_torch.data import NormStats, TrajectoryDataset
    from tpuflow_torch.data.tpf import StreamingTrajectoryDataset, TPFStore, save_tpf

    if use_native and shutil.which("g++") is None:
        pytest.skip("no g++ here: the native loader cannot build")
    rng = np.random.default_rng(5)
    lf = rng.normal(size=(4, 6, 4, 8, 3)).astype(np.float32)
    hf = rng.normal(size=(4, 6, 16, 32, 3)).astype(np.float32)
    norm = NormStats(lf_mean=lf.mean(axis=(0, 1, 2, 3)), lf_std=np.array([1, 2, 4], np.float32),
                     hf_mean=hf.mean(axis=(0, 1, 2, 3)), hf_std=np.array([2, 1, 0.5], np.float32))
    ram = TrajectoryDataset(lf, hf, norm)
    with TPFStore(save_tpf(tmp_path / "s.tpf", lf, hf), use_native=use_native) as store:
        assert store.native == use_native
        stream = StreamingTrajectoryDataset(store, norm=norm)
        for (lf_s, hf_s), (lf_r, hf_r) in zip(stream.traj_batches(0, 2), ram.traj_batches(0, 2)):
            for s, r in ((lf_s, lf_r), (hf_s, hf_r)):
                on_card = torch.from_numpy(s).to(cuda_device)
                assert torch.equal(on_card.cpu(), torch.from_numpy(r))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_registered_op_is_the_kernel(cuda_device, dtype, reverse):
    """``torch.ops.tpuflow_torch.fused_coupling`` launches K2 once per call
    (counted), bit-equal to the Python wrapper's launch, and holds against
    the plain version at the kernel's tolerances."""
    from tpuflow_torch.kernels import ops

    tol_y, tol_ld = _TOL[dtype]
    xa, xb, h0c, net = _case(_DT[dtype], cuda_device, h0c_batch=3)
    before = tk.launches
    y, ld = ops.fused_coupling(xa, xb, h0c, net, reverse=reverse)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    y_fn, ld_fn = fused_coupling(xa, xb, h0c, net, reverse=reverse)
    assert torch.equal(y, y_fn) and torch.equal(ld, ld_fn)
    y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
    torch.testing.assert_close(y, y_ref, atol=tol_y, rtol=1e-5)
    torch.testing.assert_close(ld, ld_ref, atol=tol_ld, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_served_artifact_equals_the_rollout(cuda_device, tmp_path):
    """An artifact exported on the card (``torch.export`` of the encoder
    and one step) serves the rollout of ``make_ensemble_rollout`` on a
    generator seeded the same way, denormalized, at f32 within 1e-5 x
    max(1, max |ref|), with K2 launched n_scales x n_flow_steps times per
    step."""
    import dataclasses

    from tpuflow_torch.data import NormStats
    from tpuflow_torch.tools.artifact import load_artifact, write_artifact
    from tpuflow_torch.tools.export_rollout import build_exported

    case = load_case("backward-step")
    cfg = dataclasses.replace(case, model=ModelConfig(**SMALL),
                              eval=dataclasses.replace(case.eval, rollout_steps=3, n_samples=4))
    model = TMGlow(cfg.model, device=cuda_device, seed=0)
    perturb_(model, 1, scale=0.05)
    c = np.arange(1, 4, dtype=np.float32)
    norm = NormStats(lf_mean=0.1 * c, lf_std=c, hf_mean=-0.2 * c, hf_std=0.5 * c)
    path = tmp_path / "rollout.torchexport"
    write_artifact(path, *build_exported(cfg, model, norm))
    served = load_artifact(path)
    assert served.device == torch.device("cuda", torch.cuda.current_device())
    lf = torch.randn(3, 4, 8, 3, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    tau = torch.full((2,), 0.85, device=cuda_device)
    before = tk.launches
    got = served(lf, 4, tau)
    torch.cuda.synchronize()
    assert tk.launches - before == 3 * SMALL["n_scales"] * SMALL["n_flow_steps"]
    ref = make_ensemble_rollout(model, 4, tau, "stats")(
        lf, torch.Generator(cuda_device).manual_seed(4))
    hf_std = torch.from_numpy(norm.hf_std).to(cuda_device)
    want = {"mean": ref["mean"] * hf_std + torch.from_numpy(norm.hf_mean).to(cuda_device),
            "var": ref["var"] * hf_std**2}
    for k in want:
        assert got[k].device == want[k].device and bool(torch.isfinite(got[k]).all())
        torch.testing.assert_close(got[k], want[k], rtol=0,
                                   atol=1e-5 * max(1.0, want[k].abs().max().item()))
