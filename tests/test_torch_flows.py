"""Parity of the port's bijectors (tpuflow_torch.flows) with the JAX
package's Flax modules on the same weights and inputs, both directions,
with logdet.

Inputs and weight perturbations come from numpy seeds; JAX weights come
from each Flax module's own ``init`` and cross through
``tpuflow_torch.convert.from_flax``. Tolerances are float32 ones: both
sides compute in f32 (convs at full f32 on both), and differ only in
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.flows import (
    ActNorm as JActNorm,
    AffineCoupling as JAffineCoupling,
    ConditionalPrior as JConditionalPrior,
    ConditionalSplit as JConditionalSplit,
    InvConv1x1LU as JInvConv,
    gaussian_sample as j_gaussian_sample,
    squeeze2d as j_squeeze2d,
)
import tpuflow.kernels.coupling_fused as cfk
from tpuflow.flows.inv1x1 import compute_w_inv as j_compute_w_inv
from tpuflow_torch.convert import from_flax
from tpuflow_torch.flows import (
    ActNorm,
    AffineCoupling,
    ConditionalPrior,
    ConditionalSplit,
    InvConv1x1LU,
    compute_w_inv,
    gaussian_logp,
    gaussian_sample,
    squeeze2d,
    unsqueeze2d,
)

torch.set_num_threads(1)

B, H, W, C, CC = 2, 4, 8, 8, 5


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _perturb(variables, seed, scale=0.05):
    """Add seeded noise to every param so zero-init heads and identity
    inits compute something non-trivial."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(variables["params"]),
    )
    out = dict(jax.device_get(variables))
    out["params"] = params
    return out


def _load(module, variables):
    module.load_state_dict(from_flax(variables, module))
    return module


def _close(got, want, atol, rtol=1e-5):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), atol=atol, rtol=rtol,
    )


def test_squeeze_matches_jax_and_inverts():
    x = _np(0, (B, H, W, 3))
    y = squeeze2d(_t(x))
    _close(y, j_squeeze2d(jnp.asarray(x)), atol=0, rtol=0)
    assert torch.equal(unsqueeze2d(y), _t(x))


def test_actnorm_both_directions():
    x = _np(1, (B, H, W, C), 2.0) + 1.0
    jm = JActNorm()
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2, 0.3)
    tm = _load(ActNorm(C), v)
    for reverse in (False, True):
        yj, ldj = jm.apply(v, jnp.asarray(x), reverse=reverse)
        yt, ldt = tm(_t(x), reverse=reverse)
        _close(yt, yj, atol=1e-5)
        _close(ldt, ldj, atol=1e-4)


def test_inv1x1_both_directions_and_w_inv():
    x = _np(3, (B, H, W, C))
    jm = JInvConv()
    v = _perturb(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)), 5, 0.05)
    tm = _load(InvConv1x1LU(C), v)
    for reverse in (False, True):
        yj, ldj = jm.apply(v, jnp.asarray(x), reverse=reverse)
        yt, ldt = tm(_t(x), reverse=reverse)
        _close(yt, yj, atol=1e-5)
        _close(ldt, ldj, atol=1e-4)
    p, b = v["params"], v["buffers"]
    w_inv_j = j_compute_w_inv(p["l"], p["u"], p["log_s"], b["p"], b["sign_s"])
    _close(tm.w_inv(), w_inv_j, atol=1e-5)
    _close(compute_w_inv(tm.l, tm.u, tm.log_s, tm.p, tm.sign_s), w_inv_j, atol=1e-5)
    y, _ = tm(_t(x))
    _close(tm(y, reverse=True, w_inv=tm.w_inv())[0], x, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cond_batch", [None, 1, B])
def test_affine_coupling_both_directions(reverse, cond_batch):
    x = _np(6, (B, H, W, C))
    cond = None if cond_batch is None else _np(7, (cond_batch, H, W, CC))
    kw = dict(width=8, layers=2, growth_rate=4)
    jm = JAffineCoupling(dtype=jnp.float32, conv_layout="nhwc", **kw)
    jc = None if cond is None else jnp.asarray(cond)
    v = _perturb(jm.init(jax.random.PRNGKey(8), jnp.asarray(x), jc), 9)
    tm = _load(AffineCoupling(C, None if cond is None else CC, dtype=torch.float32, **kw), v)
    yj, ldj = jm.apply(v, jnp.asarray(x), jc, reverse=reverse)
    with torch.no_grad():
        yt, ldt = tm(_t(x), None if cond is None else _t(cond), reverse=reverse)
        # Packed weights give the same function as per-call packing.
        yp, _ = tm(_t(x), None if cond is None else _t(cond), reverse=reverse,
                   packed=tm.net.pack())
    _close(yt, yj, atol=2e-5)
    _close(ldt, ldj, atol=2e-4)
    assert torch.equal(yp, yt)


@pytest.fixture
def _pallas_interpret():
    old = cfk.INTERPRET
    cfk.INTERPRET = True
    yield
    cfk.INTERPRET = old


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_coupling_matches_jax_fused_path(_pallas_interpret, dtype, reverse):
    """The port at ``use_pallas=True`` computes what the JAX package's
    fused coupling computes (``use_pallas=True``: the Pallas kernel, here
    in interpret mode), bf16 nets included: conv_in_1 of the conditioning rounded to the net
    dtype, f32 accumulation inside. Tolerances: f32 as above; bf16 1e-2,
    as ``test_torch_kernels.py`` holds the plain version against
    ``xla_reference``: the two sides agree to ~5e-7 (measured), and the
    bound leaves room for a bf16 value that rounds one ulp apart in the
    two summation orders."""
    x = _np(25, (B, H, W, C))
    cond = _np(26, (1, H, W, CC))
    jdt, tdt, tol_y, tol_ld = {
        "float32": (jnp.float32, torch.float32, 2e-5, 2e-4),
        "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2, 1e-2),
    }[dtype]
    kw = dict(width=8, layers=2, growth_rate=4)
    jm = JAffineCoupling(dtype=jdt, use_pallas=True, conv_layout="nhwc", **kw)
    v = _perturb(jm.init(jax.random.PRNGKey(27), jnp.asarray(x), jnp.asarray(cond)), 28)
    tm = _load(AffineCoupling(C, CC, dtype=tdt, use_pallas=True, **kw), v)
    yj, ldj = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), reverse=reverse)
    with torch.no_grad():
        yt, ldt = tm(_t(x), _t(cond), reverse=reverse)
    _close(yt, yj, atol=tol_y)
    _close(ldt, ldj, atol=tol_ld)


def test_affine_coupling_roundtrip():
    x = _np(10, (B, H, W, C))
    cond = _t(_np(11, (1, H, W, CC)))
    tm = AffineCoupling(C, CC, width=8, layers=2, growth_rate=4, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
        y, ld_f = tm(_t(x), cond)
        x_rec, ld_r = tm(y, cond, reverse=True)
    _close(x_rec, x, atol=1e-5, rtol=0)
    _close(ld_f, -ld_r, atol=1e-4)


def test_conditional_split_both_directions():
    z = _np(12, (B, H, W, C))
    cond = _np(13, (B, H, W, CC))
    jm = JConditionalSplit(dtype=jnp.float32)
    v = _perturb(jm.init(jax.random.PRNGKey(14), jnp.asarray(z), jnp.asarray(cond)), 15)
    tm = _load(ConditionalSplit(C, CC, dtype=torch.float32, z_clip=4.0), v)
    keep_j, drop_j, lp_j = jm.apply(v, jnp.asarray(z), jnp.asarray(cond))
    keep_t, drop_t, lp_t = tm(_t(z), _t(cond))
    _close(keep_t, keep_j, atol=0)
    _close(drop_t, drop_j, atol=0)
    _close(lp_t, lp_j, atol=1e-4)
    # Reverse with the factored latent given: exact reconstruction.
    out_j, nlp_j = jm.apply(v, keep_j, jnp.asarray(cond), reverse=True, drop=drop_j)
    out_t, nlp_t = tm.reverse(keep_t, _t(cond), drop=drop_t)
    _close(out_t, out_j, atol=1e-6)
    _close(out_t, z, atol=1e-6)
    _close(nlp_t, nlp_j, atol=1e-4)
    # Reverse drawing the latent: JAX's draw fed to the port as eps.
    rng = jax.random.PRNGKey(16)
    eps = np.asarray(jax.random.normal(rng, (B, H, W, C // 2), jnp.float32))
    jm_clip = JConditionalSplit(dtype=jnp.float32, z_clip=4.0)
    out_j, nlp_j = jm_clip.apply(v, keep_j, jnp.asarray(cond), reverse=True,
                                 rng=rng, temperature=0.85)
    out_t, nlp_t = tm.reverse(keep_t, _t(cond), temperature=0.85, eps=_t(eps))
    _close(out_t, out_j, atol=1e-5)
    _close(nlp_t, nlp_j, atol=1e-3)


def test_conditional_prior_both_directions():
    z = _np(17, (B, H, W, C))
    cond = _np(18, (B, H, W, CC))
    jm = JConditionalPrior(dtype=jnp.float32, z_clip=4.0)
    v = _perturb(jm.init(jax.random.PRNGKey(19), jnp.asarray(z), jnp.asarray(cond)), 20)
    tm = _load(ConditionalPrior(C, CC, dtype=torch.float32, z_clip=4.0), v)
    _, lp_j = jm.apply(v, jnp.asarray(z), jnp.asarray(cond))
    _, lp_t = tm(_t(z), _t(cond))
    _close(lp_t, lp_j, atol=1e-4)
    rng = jax.random.PRNGKey(21)
    z_j, nlp_j = jm.apply(v, C, jnp.asarray(cond), reverse=True, rng=rng, temperature=0.85)
    eps = np.asarray(jax.random.normal(rng, (B, H, W, C), jnp.float32))
    z_t, nlp_t = tm.reverse(_t(cond), temperature=0.85, eps=_t(eps))
    _close(z_t, z_j, atol=1e-5)
    _close(nlp_t, nlp_j, atol=1e-3)


def test_gaussian_sample_clips_not_resamples():
    mean = _np(22, (B, H, W, C))
    log_std = _np(23, (B, H, W, C), 0.3)
    eps = _np(24, (B, H, W, C), 3.0)
    rng = jax.random.PRNGKey(0)
    want = j_gaussian_sample(rng, jnp.asarray(mean), jnp.asarray(log_std), 0.7, 4.0)
    eps_j = np.asarray(jax.random.normal(rng, mean.shape, jnp.float32))
    got = gaussian_sample(_t(mean), _t(log_std), 0.7, 4.0, eps=_t(eps_j))
    _close(got, want, atol=1e-6)
    clipped = gaussian_sample(_t(mean), _t(log_std), 1.0, 4.0, eps=_t(eps))
    _close(clipped, mean + np.exp(log_std) * np.clip(eps, -4, 4), atol=1e-5)
    lp = gaussian_logp(_t(eps), _t(mean), _t(log_std))
    assert lp.shape == (B,)
    with pytest.raises(ValueError):
        gaussian_sample(_t(mean), _t(log_std), eps=_t(eps[:1]))
