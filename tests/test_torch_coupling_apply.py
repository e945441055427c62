"""The port's coupling apply + logdet (K1) on the CPU: its entry point
``tpuflow_torch.kernels.coupling_apply`` against the JAX package's XLA
path (``_xla_coupling_apply``) and its Pallas kernel in interpret mode
(``pallas_coupling_apply``), forward and reverse, at the shapes of the
JAX package's own kernel tests; roundtrip, gradients (the port's
closed-form backward against ``jax.grad``) and the ``hwnc`` layout.
The CUDA kernel itself is tested against the plain version on the card,
in ``test_torch_cuda.py``; here its launch plan is checked (every value
of a row covered once, the cluster size, the grid at the flagship
shapes) and a numpy emulation of its logdet summation order is held
against the plain version.

Tolerances are the JAX package's (``tests/test_kernels.py``): y 1e-6,
logdet 1e-5, roundtrip 1e-5, gradients 1e-5. Both sides compute the same
float32 expressions and differ only in summation order and libm.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.kernels.coupling_pallas as cpk
from tpuflow.kernels.coupling_ops import _xla_coupling_apply
from tpuflow.kernels.coupling_pallas import pallas_coupling_apply
from tpuflow_torch.kernels import coupling_apply as ka
from tpuflow_torch.kernels.coupling_apply import (
    coupling_apply,
    coupling_apply_reference,
    launch_plan,
)

torch.set_num_threads(1)

# Odd spatial and channel sizes and an extra leading axis, as the JAX tests.
SHAPES = [(2, 4, 4, 4), (3, 5, 7, 3), (2, 2, 8, 16, 2)]


@pytest.fixture
def _interpret():
    old = cpk.INTERPRET
    cpk.INTERPRET = True
    yield
    cpk.INTERPRET = old


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    raw = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    t = rng.standard_normal(shape).astype(np.float32)
    return x, raw, t


def _jax_fn(which):
    return {"xla": _xla_coupling_apply, "pallas": pallas_coupling_apply}[which]


@pytest.mark.parametrize("which", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_matches_jax(_interpret, which, shape, reverse):
    x, raw, t = _inputs(shape)
    y_j, ld_j = _jax_fn(which)(*map(jnp.asarray, (x, raw, t)), reverse=reverse)
    y, ld = coupling_apply(*map(torch.tensor, (x, raw, t)), reverse=reverse)
    assert y.dtype == torch.float32 and y.shape == shape and ld.shape == shape[:-3]
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), atol=1e-5, rtol=1e-6)


def test_roundtrip():
    x, raw, t = map(torch.tensor, _inputs((2, 4, 6, 4), seed=3))
    y, ld_f = coupling_apply(x, raw, t)
    x_rec, ld_r = coupling_apply(y, raw, t, reverse=True)
    np.testing.assert_allclose(x_rec.numpy(), x.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ld_f.numpy(), -ld_r.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 2), (3, 5, 7, 3)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gradients_match_jax(_interpret, which, shape, reverse):
    """The closed-form backward against jax.grad of sum(y^2) + sum(ld^2)/2,
    through the JAX XLA path and through the Pallas kernel's custom_vjp."""
    x, raw, t = _inputs(shape, seed=6)
    fn = _jax_fn(which)

    def loss_j(x, raw, t):
        y, ld = fn(x, raw, t, reverse=reverse)
        return jnp.sum(y**2) + 0.5 * jnp.sum(ld**2)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (x, raw, t)))
    xs = [torch.tensor(a, requires_grad=True) for a in (x, raw, t)]
    y, ld = coupling_apply(*xs, reverse=reverse)
    (y.pow(2).sum() + 0.5 * ld.pow(2).sum()).backward()
    for a, b in zip(xs, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_hwnc_layout_matches_jax(reverse):
    """(H, W, N, C) tensors reduce over (H, W, C), as the JAX XLA path;
    forward values and gradients."""
    x, raw, t = _inputs((4, 6, 3, 2), seed=9)

    def loss_j(x, raw, t):
        y, ld = _xla_coupling_apply(x, raw, t, reverse=reverse, layout="hwnc")
        return jnp.sum(y**2) + 0.5 * jnp.sum(ld**2), (y, ld)

    (_, (y_j, ld_j)), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x, raw, t)))
    xs = [torch.tensor(a, requires_grad=True) for a in (x, raw, t)]
    y, ld = coupling_apply(*xs, reverse=reverse, layout="hwnc")
    y_ref, ld_ref = coupling_apply_reference(*xs, reverse=reverse, layout="hwnc")
    assert ld.shape == (3,)
    for got in ((y, ld), (y_ref, ld_ref)):
        np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(y_j), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(ld_j), atol=1e-5, rtol=1e-6)
    (y.pow(2).sum() + 0.5 * ld.pow(2).sum()).backward()
    for a, b in zip(xs, g_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_cpu_runs_plain_version_and_checks_arguments():
    x, raw, t = map(torch.tensor, _inputs((2, 3, 5, 3), seed=4))
    before = ka.launches
    y, ld = coupling_apply(x, raw, t, use_pallas=True)
    y_ref, ld_ref = coupling_apply_reference(x, raw, t)
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)
    assert ka.launches == before  # the plain version is no launch
    # bfloat16 inputs are computed in float32, as the JAX entry point casts.
    y16, _ = coupling_apply(x.bfloat16(), raw, t)
    assert y16.dtype == torch.float32
    with pytest.raises(ValueError, match="share one"):
        coupling_apply(x, raw[..., :2], t)
    with pytest.raises(ValueError, match="layout"):
        coupling_apply(x, raw, t, layout="nchw")
    with pytest.raises(ValueError, match="unsupported device"):
        coupling_apply(x.to("meta"), raw.to("meta"), t.to("meta"))


# Row lengths for the launch plan: odd and tiny, D % 4 of 0-3, the three
# Glow scales' D (3072, 6144, 12288) and one row that needs the full cluster.
PLAN_D = [1, 3, 7, 30, 105, 256, 3072, 6144, 12288, 524288]
FLAGSHIP = [(64, 32, 64, 6), (64, 16, 32, 12), (64, 8, 16, 24)]


@pytest.mark.parametrize("head", range(4))
@pytest.mark.parametrize("rows", [1, 64, 70000])
@pytest.mark.parametrize("d", PLAN_D)
def test_launch_plan_covers_each_value_once(d, rows, head):
    """Head, bodies and tail of a row whose start lies ``head`` values
    before a 16-byte boundary cover each value exactly once; every body
    starts on a boundary and is whole vectors."""
    plan = launch_plan(rows, d)
    assert 1 <= plan.cluster <= 8 and plan.rows == rows
    assert plan.vec == 4 and plan.threads % 32 == 0
    head = min(head, d)
    (h0, h1), bodies, (t0, t1) = plan.split(head)
    assert (h0, h1) == (0, head) and len(bodies) == plan.cluster and t1 == d and t1 - t0 < 4
    covered = np.zeros(d, np.int64)
    covered[h0:h1] += 1
    covered[t0:t1] += 1
    for b0, b1 in bodies:
        assert (b0 - head) % 4 == 0 and (b1 - b0) % 4 == 0
        assert (b1 - b0) // 4 <= plan.vec_per_rank
        covered[b0:b1] += 1
    assert (covered == 1).all()
    # Each row's head ends on the first 16-byte boundary past its start
    # (the tensors start on one), or takes the whole row.
    for r in range(min(rows, 4)):
        h = plan.head(r)
        assert 0 <= h < 4 and (h == d or (r * d + h) % 4 == 0)


@pytest.mark.parametrize("shape", FLAGSHIP)
def test_launch_plan_fills_the_card_at_the_flagship_shapes(shape):
    plan = launch_plan(shape[0], math.prod(shape[1:]))
    assert plan.rows * plan.cluster >= 2 * 132
    assert plan.vec_per_rank >= plan.threads  # every thread gets a vector
    assert all(plan.head(r) == 0 for r in range(plan.rows))


def test_launch_plan_refuses_what_the_grid_cannot_hold():
    assert launch_plan(2**31 - 1, 4).cluster == 1
    with pytest.raises(ValueError, match="out of range"):
        launch_plan(2**31, 4)


def _emulated_ld(plan, log_s, head):
    """The kernel's logdet of one row, in its order: each thread's partial
    (head value, its body vectors in launch order, tail value), the warp
    shuffle tree, the warps in order, the ranks in order; float32."""
    (_, h1), bodies, (t0, t1) = plan.split(head)
    lanes = np.arange(plan.threads)
    total = np.float32(0)
    for rank, (b0, b1) in enumerate(bodies):
        partial = np.zeros(plan.threads, np.float32)
        if rank == 0:
            partial[:h1] += log_s[:h1]
        vecs = log_s[b0:b1].reshape(-1, plan.vec)
        step = plan.unroll * plan.threads
        for first in range(0, len(vecs), step):
            for u in range(plan.unroll):
                idx = first + u * plan.threads + lanes
                ok = idx < len(vecs)
                for comp in range(plan.vec):
                    partial[ok] += vecs[idx[ok], comp]
        if rank == plan.cluster - 1:
            partial[:t1 - t0] += log_s[t0:t1]
        warps = partial.reshape(-1, 32)
        for offset in (16, 8, 4, 2, 1):
            warps = np.concatenate([warps[:, :32 - offset] + warps[:, offset:],
                                    warps[:, 32 - offset:]], axis=1)
        block = np.float32(0)
        for w in warps[:, 0]:
            block = np.float32(block + w)
        total = np.float32(total + block)
    return total


@pytest.mark.parametrize("head", range(4))
@pytest.mark.parametrize("d", PLAN_D)
def test_kernel_summation_order_matches_plain_version(d, head):
    """The fixed order the kernel sums log s in (emulated in numpy from the
    plan) against the plain version, 1e-5 relative to max(1, |ld|)."""
    rng = np.random.default_rng(d + head)
    raw = (0.5 * rng.standard_normal(d)).astype(np.float32)
    log_s = np.minimum(raw + 2, 0).astype(np.float32) - np.log1p(np.exp(-np.abs(raw + 2)))
    log_s = log_s.astype(np.float32)
    got = _emulated_ld(launch_plan(64, d), log_s, min(head, d))
    t = torch.zeros(1, 1, 1, d)
    _, want = coupling_apply_reference(t, torch.from_numpy(raw).view(1, 1, 1, d), t)
    assert abs(float(got) - want.item()) <= 1e-5 * max(1.0, abs(want.item()))
