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


def _oihw_case(seed=0, b=2, h=8, w=16, ca=3, cb=3):
    """OIHW kernels with Cout not a multiple of 8 (so the packing pads)."""
    total0 = LAYERS * GROWTH + 2 * ca
    c = _case(b=b, h=h, w=w, ca=ca, cb=cb, h0c_batch=1, seed=seed)
    c["win0_oihw"] = _np(seed + 20, (WIDTH, cb, 3, 3), 0.2)
    c["wjs_oihw"] = [_np(seed + 30 + j, (total0 - j * GROWTH, WIDTH if j == 0 else GROWTH, 3, 3),
                         0.1) for j in range(LAYERS + 1)]
    # The JAX package's packing: HWIO reshaped to (9*Cin, Cout), no pad.
    c["win0"] = c["win0_oihw"].transpose(2, 3, 1, 0).reshape(9 * cb, WIDTH)
    c["wjs"] = [wj.transpose(2, 3, 1, 0).reshape(-1, wj.shape[0]) for wj in c["wjs_oihw"]]
    return c


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_pack_net_matches_xla_reference(dtype, reverse):
    """pack_net's padded layout through the plain version against the JAX
    package's xla_reference on the same OIHW weights (joint Couts 30, 22,
    14, 6: every one padded)."""
    jdt, tdt, tol_y, tol_ld = _DT[dtype]
    c = _oihw_case()
    net = tk.pack_net(torch.tensor(c["win0_oihw"]), torch.tensor(c["b0"]),
                      [torch.tensor(w) for w in c["wjs_oihw"]], torch.tensor(c["bj0"]), tdt)
    assert [wj.shape[1] for wj in net.wjs] == [32, 24, 16, 8]
    assert net.width == WIDTH and net.growth == GROWTH and net.couts == (30, 22, 14, 6)
    y_j, ld_j = cfk.xla_reference(*_jax_args(c, jdt), _jax_cfg(jdt, reverse))
    xa, xb, h0c = _torch_inputs(c, tdt)
    y_t, ld_t = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=tol_y, rtol=1e-5)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), atol=tol_ld, rtol=1e-5)


@pytest.mark.parametrize("cout,cin", [(1, 1), (12, 32), (64, 6), (108, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_kernel_pads_with_zeros_and_unpacks(cout, cin, dtype):
    w = torch.from_numpy(_np(cout + cin, (cout, cin, 3, 3)))
    packed = tk.pack_kernel(w, dtype)
    n_pad = -(-cout // 8) * 8
    assert packed.shape == (9 * cin, n_pad) and packed.dtype == dtype and packed.is_contiguous()
    assert not packed[:, cout:].any()
    assert torch.equal(tk.unpack_kernel(packed, cout), w.to(dtype))
    # Rows are (dy, dx, cin), as the JAX package's HWIO reshape.
    np.testing.assert_array_equal(packed[:, :cout].float().numpy(),
                                  w.to(dtype).float().numpy().transpose(2, 3, 1, 0)
                                  .reshape(9 * cin, cout))


_SCALES = [(32, 64, 6), (16, 32, 12), (8, 16, 24)]  # backward-step: (H, W, ca) per scale


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("b", [64, 8])
@pytest.mark.parametrize("scale", [0, 1, 2])
def test_tile_plan_fits_the_card(scale, b, width):
    """The bf16 kernel's plan of every layer of a backward-step coupling
    (growth 32, L = 3): within 227 KB of shared memory and 16 warps, a
    grid that covers the image, conflict-free strides, zero-padded K and
    N that cover cin and cout, weight buffers that fit; at B = 64 the
    tiles named in the plan's notes (scale 0: 4 rows, 512 tiles; scale 2:
    half a member, 128 tiles)."""
    h, w, ca = _SCALES[scale]
    growth, layers = 32, 3
    plans = tk.coupling_plans(b, h, w, ca, ca, width, growth, layers)
    total0 = layers * growth + 2 * ca
    layer_io = [(ca, width)] + [(width if j == 0 else growth, total0 - j * growth)
                                for j in range(layers + 1)]
    assert len(plans) == len(layer_io) == layers + 2
    for (cin, cout), p in zip(layer_io, plans):
        assert p.smem <= 232448 and 32 <= p.threads <= 512
        assert p.tiles * p.rows >= h > (p.tiles - 1) * p.rows and p.rows * w <= 256
        assert p.warps_m * 64 >= p.rows * w and p.warps_n * 32 >= p.n_pad >= cout
        assert p.cin_pad % 16 == 0 and p.cin_pad >= cin and p.n_pad % 8 == 0
        assert p.n16 % 16 == 0 and p.n16 >= p.n_pad
        for stride in (p.a_stride, p.b_stride):  # odd multiples of 16 bytes
            assert (2 * stride) % 32 == 16
        assert p.a_stride >= p.cin_pad and p.b_stride >= p.n16
        assert p.b_off % 16 == 0 and p.b_off >= (p.rows + 2) * (w + 2) * p.a_stride * 2
        assert (p.taps, p.nbuf) in ((9, 1), (1, 3))
        # Resident weights only within the block's share of an SM.
        assert p.smem <= 113 * 1024 or p.threads > 256 or (p.taps, p.nbuf) != (9, 1)
        assert p.x_off >= p.b_off + p.nbuf * p.taps * p.cin_pad * p.b_stride * 2
        assert p.b_off % 16 == p.x_off % 16 == p.t_off % 16 == p.red_off % 16 == 0
        assert p.smem >= p.red_off >= p.t_off >= p.x_off
    # Scratch strides: each layer writes its relu features with the pixel
    # stride the next one reads them with; the running sums' rows start on
    # 16 bytes. The shared tiles' rows hold every column, start on 16
    # bytes and are no multiple of 16 values (bank rounds of the stage).
    for p, nxt in zip(plans, plans[1:]):
        assert p.ld_out == nxt.cin_pad
    assert plans[-1].ld_out == 0
    for p, (cin, cout) in zip(plans, layer_io):
        assert p.t_stride % 4 == 0 and p.t_stride % 16 != 0 and cout <= p.t_stride < cout + 12
        assert p.red_off >= p.rows * w * p.t_stride * 4  # the f32 output stage, from 0
        if p is not plans[0]:
            assert p.ld_acc == plans[1].ld_acc >= total0 and p.ld_acc % 4 == 0
            assert p is plans[-1] or -(-(cout - growth) // 4) * 4 <= p.ld_acc  # 16-byte stores
    conv_in, *joints = plans
    assert conv_in.t_off - conv_in.x_off >= (conv_in.rows + 2) * w * ca * 4  # f32 rows
    assert conv_in.red_off - conv_in.t_off >= conv_in.rows * w * conv_in.t_stride * 2  # h0c
    assert joints[0].t_off == joints[0].x_off  # joint_0 reads no running sums
    for p, (cin, cout) in zip(joints[1:], layer_io[2:]):
        assert p.red_off - p.t_off >= p.rows * w * p.t_stride * 4
    assert joints[-1].smem >= joints[-1].red_off + 64
    assert len({(p.rows, p.tiles) for p in plans}) == 1  # one tiling per coupling
    if b == 64:
        assert (plans[0].rows, b * plans[0].tiles) == [(4, 512), (4, 256), (4, 128)][scale]


def test_tile_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="W <= 128"):
        tk.tile_plan(1, 4, 129, 16, 16)
    with pytest.raises(ValueError, match="shared memory"):
        tk.tile_plan(1, 4, 128, 512, 512)
