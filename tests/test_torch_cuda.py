"""The port's CUDA kernel on the card: the fused coupling (K2) against its
plain version, the wrapper's refusals, and a small rollout through the
kernel against the same rollout on the CPU.

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
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.configs import ModelConfig
from tpuflow_torch.device import resolve_device
from tpuflow_torch.eval import make_ensemble_rollout
from tpuflow_torch.kernels import coupling_fused as tk
from tpuflow_torch.kernels.coupling_fused import (
    fused_coupling,
    fused_coupling_reference,
    pack_net,
)
from tpuflow_torch.models import TMGlow, scale_shapes

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
