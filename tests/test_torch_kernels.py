"""The port's fused coupling (K2): its plain version against the JAX
package's ``xla_reference`` and Pallas kernel (interpret mode), the
wrapper's CPU dispatch. The CUDA kernel itself is tested against the
plain version on the card, in ``test_torch_cuda.py``.

Tolerances: at float32, y 2e-5 and logdet 2e-4, as the JAX package's
own fused-kernel tests (both sides accumulate in f32 and differ only in
summation order; the logdet sums H*W*ca terms). At bfloat16 both sides
round the same inputs and weights to bf16 and accumulate in f32, so on
the CPU they agree to ~2e-6 (measured); the bound, y 1e-2, leaves room
for a relu feature whose f32 sum lands on a bf16 rounding boundary and
rounds one ulp apart (2^-8 relative) in one summation order and not the
other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.kernels.coupling_fused as cfk
from tpuflow_torch.kernels import coupling_fused as tk
from tpuflow_torch.kernels.coupling_fused import (
    PackedNet,
    fused_coupling,
    fused_coupling_reference,
)

torch.set_num_threads(1)

WIDTH, GROWTH, LAYERS = 16, 8, 3


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _case(b=3, h=8, w=16, ca=6, cb=6, h0c_batch=1, seed=0):
    """Inputs and packed weights as numpy f32 (weights non-zero in the
    head, so the coupling is not a constant scale)."""
    total0 = LAYERS * GROWTH + 2 * ca
    wjs = [
        _np(seed + 10 + j, (9 * (WIDTH if j == 0 else GROWTH), total0 - j * GROWTH), 0.1)
        for j in range(LAYERS + 1)
    ]
    return dict(
        xa=_np(seed + 1, (b, h, w, ca)),
        xb=_np(seed + 2, (b, h, w, cb)),
        h0c=None if h0c_batch is None else _np(seed + 3, (h0c_batch, h, w, WIDTH), 0.5),
        win0=_np(seed + 4, (9 * cb, WIDTH), 0.2),
        b0=_np(seed + 5, (WIDTH,), 0.1),
        wjs=wjs,
        bj0=_np(seed + 6, (total0,), 0.1),
    )


def _torch_net(c, dtype, device="cpu"):
    return PackedNet(
        torch.tensor(c["win0"]).to(device, dtype),
        torch.tensor(c["b0"]).to(device),
        tuple(torch.tensor(w).to(device, dtype) for w in c["wjs"]),
        torch.tensor(c["bj0"]).to(device),
    )


def _torch_inputs(c, dtype, device="cpu"):
    h0c = None if c["h0c"] is None else torch.tensor(c["h0c"]).to(device, dtype)
    return torch.tensor(c["xa"]).to(device), torch.tensor(c["xb"]).to(device), h0c


def _jax_args(c, dtype):
    b, h, w, _ = c["xa"].shape
    h0c = np.zeros((1, h, w, WIDTH), np.float32) if c["h0c"] is None else c["h0c"]
    return (
        jnp.asarray(c["xa"]), jnp.asarray(c["xb"]), jnp.asarray(h0c, dtype),
        jnp.asarray(c["win0"], dtype), jnp.asarray(c["b0"]).reshape(1, -1),
        tuple(jnp.asarray(wj, dtype) for wj in c["wjs"]),
        jnp.asarray(c["bj0"]).reshape(1, -1),
    )


def _jax_cfg(dtype, reverse):
    return cfk._cfg(WIDTH, GROWTH, LAYERS, dtype, reverse)


_DT = {"float32": (jnp.float32, torch.float32, 2e-5, 2e-4),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2, 1e-2)}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0c_batch", [None, 1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_xla_reference(dtype, h0c_batch, reverse):
    jdt, tdt, tol_y, tol_ld = _DT[dtype]
    c = _case(h0c_batch=h0c_batch)
    y_j, ld_j = cfk.xla_reference(*_jax_args(c, jdt), _jax_cfg(jdt, reverse))
    xa, xb, h0c = _torch_inputs(c, tdt)
    y_t, ld_t = fused_coupling_reference(xa, xb, h0c, _torch_net(c, tdt), reverse=reverse)
    assert y_t.dtype == torch.float32 and y_t.shape == (3, 8, 16, 12)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=tol_y, rtol=1e-5)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=tol_ld, rtol=1e-5)


@pytest.fixture
def _pallas_interpret():
    old = cfk.INTERPRET
    cfk.INTERPRET = True
    yield
    cfk.INTERPRET = old


@pytest.mark.parametrize("reverse", [False, True])
def test_reference_matches_pallas_kernel_interpret(_pallas_interpret, reverse):
    c = _case(b=2, h=4, w=8, ca=2, cb=2, h0c_batch=1)
    y_j, ld_j = cfk._fused_pallas(*_jax_args(c, jnp.float32), _jax_cfg(jnp.float32, reverse))
    xa, xb, h0c = _torch_inputs(c, torch.float32)
    y_t, ld_t = fused_coupling_reference(xa, xb, h0c, _torch_net(c, torch.float32),
                                         reverse=reverse)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=2e-4, rtol=1e-5)


def test_wrapper_takes_plain_version_on_cpu_only():
    c = _case()
    xa, xb, h0c = _torch_inputs(c, torch.float32)
    net = _torch_net(c, torch.float32)
    before = tk.launches
    y, ld = fused_coupling(xa, xb, h0c, net)
    y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, net)
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)
    assert tk.launches == before  # the plain version is no launch
    assert net.width == WIDTH and net.growth == GROWTH and net.layers == LAYERS
    with pytest.raises(ValueError, match="unsupported device"):
        fused_coupling(xa.to("meta"), xb.to("meta"), None, net)


def test_roundtrip_through_plain_version():
    c = _case(h0c_batch=3)
    xa, xb, h0c = _torch_inputs(c, torch.float32)
    net = _torch_net(c, torch.float32)
    y, ld_f = fused_coupling_reference(xa, xb, h0c, net)
    ca = xa.shape[-1]
    x_rec, ld_r = fused_coupling_reference(
        y[..., :ca].contiguous(), y[..., ca:].contiguous(), h0c, net, reverse=True)
    np.testing.assert_allclose(x_rec[..., :ca].numpy(), c["xa"], atol=1e-5)
    np.testing.assert_allclose(ld_f.numpy(), -ld_r.numpy(), atol=1e-4, rtol=1e-6)
