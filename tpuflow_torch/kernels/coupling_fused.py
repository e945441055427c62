"""The whole affine coupling in one call: K2 of the JAX package, on Hopper.

Counterpart of ``tpuflow/kernels/coupling_fused.py``. One call computes a
GlowStep's coupling net (the dense-block 3x3 convs), the affine apply and
the logdet:

  * :func:`fused_coupling` is the wrapper. On CUDA tensors it launches the
    hand-written kernel in ``csrc/coupling_fused.cu`` (built by
    ``_build.py`` with nvcc, bound with ctypes) or raises; it takes the
    plain version only for tensors that lie on the CPU.
  * :func:`fused_coupling_reference` is the plain PyTorch version, the
    counterpart of the JAX package's ``xla_reference``. The CPU runs it,
    and the kernel is held against it on the card.

Numerics: two modes, chosen by ``PackedNet.fused`` (the model sets it from
``model.use_pallas``). In both, every product of net-dtype operands
accumulates in float32, and the affine and the logdet are float32.

  * ``fused=True``: the JAX package's fused coupling (``xla_reference``,
    what ``use_pallas=True`` computes on a TPU). The sums stay float32;
    only the relu features are rounded to the net dtype.
  * ``fused=False``: the JAX package's default XLA path (``use_pallas:
    false``, the presets' and every committed checkpoint's setting). Each
    conv's output is rounded to the net dtype, and so is every sum flax
    computes in it: with r() the rounding, conv_in gives
    ``r(r(r(conv) + r(b0)) + h0c)``, joint_0 ``r(r(conv) + r(bj0))``, and
    joint j > 0 adds each column block into its target as ``acc =
    r(acc + r(conv))``, in the order j = 0, 1, ...; the head (raw, t) is
    that rounded target.

At float32 r() is the identity, so the two modes are bit-equal. The
plain version reproduces float32 accumulation of bfloat16 operands on the
CPU by rounding inputs and weights to bfloat16 and then convolving in
float32 (products of bfloat16 values are exact in float32); it writes r()
as ``.to(net dtype).float()``, so autograd rounds the cotangents at the
same points, as JAX's bfloat16 VJP does.

Weights are packed (:func:`pack_net`): conv kernels as (9*Cin, n_pad) in
the net dtype with rows ordered (dy, dx, cin) and the Cout columns padded
with zeros up to n_pad, a multiple of 8 (so every row is a whole number
of 16-byte chunks that the kernel copies with ``cp.async``); biases
float32. The plain version slices the pad columns off again. A rollout
packs them once, detached, and calls :func:`fused_coupling` directly,
which refuses CUDA inputs that require grad.

Kernels, by net dtype. bfloat16 runs each conv as an implicit GEMM on the
tensor cores (``mma.sync`` with bf16 operands and f32 accumulation), laid
out by :func:`tile_plan`, a pure function that the CPU tests check;
float32 runs direct convs on the CUDA cores (bf16 tensor cores cannot
give f32 products). That is dispatch by dtype, not a fallback.

Gradients: :func:`fused_coupling_autograd` takes the OIHW parameters and
packs them inside a ``torch.autograd.Function``, the counterpart of the
JAX package's ``custom_vjp`` ``_fused``. Its forward runs
:func:`fused_coupling` (so every forward of training launches the
kernel); its backward recomputes :func:`fused_coupling_reference` under
autograd and differentiates it, as ``_fused_bwd`` differentiates
``xla_reference`` (the JAX package has no backward kernel either).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

_SCALE_SHIFT = 2.0  # sigmoid(raw + 2): coupling starts near identity

# Kernel launches by fused_coupling since the last reset (a plain count:
# a run sets it to 0, drives the path, and reads it).
launches = 0

_ENTRY = {torch.float32: "tpf_fused_coupling_f32", torch.bfloat16: "tpf_fused_coupling_bf16"}
_MAX_W = 128  # widest row the kernels' shared-memory tiles take

# The bf16 kernel's tiling (csrc/coupling_fused.cu: kWarpM, kWarpN,
# kMaxMmaThreads, kMaxSmem) and the H100 SXM's SM count.
_WARP_M, _WARP_N, _MAX_WARPS = 64, 32, 16
_TILE_PIXELS = 256  # pixels of a tile at most: four warps along M
_MAX_SMEM = 232448  # 227 KB, the most a block may use
_SMEM_SHARE = 113 * 1024  # at most this, two blocks share an SM's 228 KB
_SHARED_THREADS = 256  # above this, one block's registers fill an SM
# Weight buffering, in order of preference: (taps per buffer, buffers).
# All nine taps resident (one copy, no barrier between taps), else a ring
# of three one-tap buffers, two taps in flight (the kernel's wait count).
_WEIGHT_BUFFERS = ((9, 1), (1, 3))
_N_SMS = 132


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class TilePlan(NamedTuple):
    """One layer's launch of the bf16 tensor-core kernel; its fields are
    the kernel's ``Plan`` struct, in its order. Its scratch in device
    memory: the relu features it writes (``ld_out`` bf16 values per
    pixel, columns past the written ones unused) and the f32 running sums
    of the growth targets (``ld_acc`` per pixel; a layer's targets start
    each pixel's row). Shared memory holds, at these byte offsets: the
    bf16 input halo (at 0), the weight buffers (``b_off``), conv_in's f32
    input rows (``x_off``), the tile the epilogue adds (``t_off``:
    conv_in's h0c, a joint layer's running sums) and the logdet's warp
    sums (``red_off``). Once the products are done, the f32 output stage
    takes the bytes from 0 up to ``red_off``."""

    rows: int  # image rows per tile (a tile is whole rows of one member)
    tiles: int  # row tiles per member: grid (tiles, B)
    warps_m: int  # warps along the tile's pixels, 64 each
    warps_n: int  # warps along the columns, 32 each
    cin_pad: int  # K per tap: cin rounded up to 16 (zeros)
    a_stride: int  # halo pixel stride in shared memory, bf16 values
    n_pad: int  # packed weight row stride: cout rounded up to 8
    n16: int  # columns ldmatrix reads: n_pad rounded up to 16
    b_stride: int  # weight row stride in shared memory, bf16 values
    taps: int  # taps per weight buffer: 9 (all resident) or 1 (a ring)
    nbuf: int  # weight buffers: 1 with taps = 9, else 3
    t_stride: int  # row stride of the shared tiles: >= cout, 4k but not 16k
    ld_out: int  # pixel stride of the relu features written: the next cin_pad
    ld_acc: int  # pixel stride of the running sums: round4(acc_cols)
    b_off: int
    x_off: int
    t_off: int
    red_off: int
    smem: int  # dynamic shared memory bytes

    @property
    def threads(self) -> int:
        return 32 * self.warps_m * self.warps_n


@functools.lru_cache(maxsize=None)
def tile_plan(b: int, h: int, w: int, cin: int, cout: int, *, conv_in: bool = False,
              reads_acc: bool = False, last: bool = False, feat_cols: int = 0,
              acc_cols: int = 0) -> TilePlan:
    """Tile plan of one 3x3 conv layer of the bf16 kernel, for B members of
    H x W pixels, cin -> cout channels. ``conv_in``: the first layer (f32
    input rows staged as they are; the h0c tile); ``reads_acc``: a joint
    layer that adds to the targets' running sums (their tile is staged);
    ``last``: the joint layer whose epilogue applies the affine;
    ``feat_cols``: the relu columns it writes (0 for the last layer);
    ``acc_cols``: the running sums' columns (joint_0's cout).

    A tile is whole image rows of one member, at most 256 pixels and 16
    warps: every block reads all of the layer's weights, so a larger tile
    reads fewer weight bytes per pixel. Rows are halved while the grid has
    fewer tiles than the card has SMs and a tile keeps at least one warp's
    64 pixels: at B = 64 that gives 4 x 64 rows at scale 0 (512 tiles),
    4 x 32 at scale 1 (256) and half a member, 4 x 16, at scale 2 (128).
    The weights are all resident if they fit the block's share of an SM
    (half of it while two blocks' registers fit one SM), else streamed
    (:data:`_WEIGHT_BUFFERS`). Pixel and row strides in shared memory are
    odd multiples of 16 bytes, so ldmatrix's 8 row addresses fall in
    distinct banks; the tiles' ``t_stride`` is not a multiple of 16
    values, so the stage's 8-byte stores from 4 rows at a time fall in at
    most two rounds. A layer reads its input features with pixel stride
    ``cin_pad`` and writes them with ``ld_out``, the next layer's
    ``cin_pad``; together with ``ld_acc`` and ``t_stride``, every row the
    kernel copies starts on 16 bytes. Raises if the layer does not fit a
    block.
    """
    if not 1 <= w <= _MAX_W or h < 1 or b < 1 or cin < 1 or cout < 1:
        raise ValueError(f"tile_plan: unsupported layer b={b} h={h} w={w} "
                         f"cin={cin} cout={cout} (W <= {_MAX_W})")
    n_pad = _round_up(cout, 8)
    warps_n = -(-n_pad // _WARP_N)
    max_pixels = min(_TILE_PIXELS, _WARP_M * max(1, _MAX_WARPS // warps_n))
    rows = max(1, min(h, max_pixels // w))
    while rows > 1 and b * -(-h // rows) < _N_SMS and (rows // 2) * w >= _WARP_M:
        rows //= 2
    m_tile = rows * w
    cin_pad = _round_up(cin, 16)
    a_stride = cin_pad + 8
    n16 = _round_up(n_pad, 16)
    b_stride = n16 + 8
    warps_m = -(-m_tile // _WARP_M)
    b_off = _round_up((rows + 2) * (w + 2) * a_stride * 2, 16)
    x_bytes = (rows + 2) * w * cin * 4 if conv_in else 0
    t_stride = _round_up(cout, 4)
    t_stride += 8 if t_stride % 16 == 0 else 0
    t_bytes = m_tile * t_stride * (2 if conv_in else 4 if reads_acc else 0)
    stage = m_tile * t_stride * 4

    def layout(taps, nbuf):  # (taps, nbuf, x_off, t_off, red_off, smem)
        x_off = b_off + _round_up(nbuf * taps * cin_pad * b_stride * 2, 16)
        t_off = x_off + _round_up(x_bytes, 16)
        red_off = _round_up(max(t_off + t_bytes, stage), 16)
        return taps, nbuf, x_off, t_off, red_off, red_off + (4 * _MAX_WARPS if last else 0)

    options = [layout(taps, nbuf) for taps, nbuf in _WEIGHT_BUFFERS]
    share = _SMEM_SHARE if 32 * warps_m * warps_n <= _SHARED_THREADS else _MAX_SMEM
    fits = ([o for o in options if o[-1] <= share]
            or [o for o in options if o[-1] <= _MAX_SMEM])
    if warps_m * warps_n > _MAX_WARPS or not fits:
        raise ValueError(
            f"tile_plan: layer {cin}->{cout} at W={w} needs {warps_m * warps_n} warps and "
            f"{options[-1][-1]} bytes of shared memory (at most {_MAX_WARPS} and {_MAX_SMEM})")
    taps, nbuf, x_off, t_off, red_off, smem = fits[0]
    return TilePlan(rows, -(-h // rows), warps_m, warps_n, cin_pad, a_stride, n_pad, n16,
                    b_stride, taps, nbuf, t_stride, _round_up(feat_cols, 16),
                    _round_up(acc_cols, 4), b_off, x_off, t_off, red_off, smem)


def coupling_plans(b: int, h: int, w: int, ca: int, cb: int, width: int, growth: int,
                   layers: int) -> list[TilePlan]:
    """The bf16 kernel's plans of one coupling: conv_in, then joint_0..L."""
    total0 = layers * growth + 2 * ca
    plans = [tile_plan(b, h, w, cb, width, conv_in=True, feat_cols=width)]
    for j in range(layers + 1):
        plans.append(tile_plan(b, h, w, width if j == 0 else growth, total0 - j * growth,
                               reads_acc=j > 0, last=j == layers,
                               feat_cols=growth if j < layers else 0, acc_cols=total0))
    return plans


class _Launch(NamedTuple):
    """What the bf16 wrapper needs of :func:`coupling_plans`, per pixel."""

    plans: ctypes.Array  # the C entry's flat int array
    feat: int  # bf16 values of relu features: the sum of the plans' ld_out
    acc: int  # f32 running sums: ld_acc
    tiles: int  # logdet partials per member: the last layer's tiles


@functools.lru_cache(maxsize=256)
def _launch(b, h, w, ca, cb, width, growth, layers) -> _Launch:
    plans = coupling_plans(b, h, w, ca, cb, width, growth, layers)
    flat = [v for p in plans for v in p]
    return _Launch((ctypes.c_int * len(flat))(*flat), sum(p.ld_out for p in plans),
                   plans[1].ld_acc, plans[-1].tiles)


class PackedNet(NamedTuple):
    """A coupling net's weights in the kernel's layout, and its numerics.

    win0: (9*cb, n_pad(width)) conv_in_0 kernel, net dtype; b0: (width,)
    f32; wjs: joint_j kernels (9*Cin_j, n_pad(total_j)), net dtype; bj0:
    (total_0,) f32. The true widths come from the biases and the rows.
    fused: the JAX package's fused numerics (True) or its default XLA
    path's (False); see the module docstring.
    """

    win0: torch.Tensor
    b0: torch.Tensor
    wjs: tuple[torch.Tensor, ...]
    bj0: torch.Tensor
    fused: bool = True

    @property
    def width(self) -> int:
        return self.b0.shape[0]

    @property
    def layers(self) -> int:
        return len(self.wjs) - 1

    @property
    def growth(self) -> int:
        return self.wjs[1].shape[0] // 9 if self.layers else 0

    @property
    def couts(self) -> tuple[int, ...]:
        """Output columns of joint_0..L (the rest of a packed row is pad)."""
        total0, growth = self.bj0.shape[0], self.growth
        return tuple(total0 - j * growth for j in range(self.layers + 1))

    @property
    def net_dtype(self) -> torch.dtype:
        return self.win0.dtype


def pack_kernel(weight_oihw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW 3x3 kernel -> (9*Cin, n_pad) in ``dtype``, rows (dy, dx, cin),
    the Cout columns zero-padded up to n_pad, a multiple of 8. Two ops
    (a zero fill and one cast-and-permute copy), differentiable."""
    cout, cin = weight_oihw.shape[:2]
    out = weight_oihw.new_zeros((3, 3, cin, _round_up(cout, 8)), dtype=dtype)
    out[..., :cout] = weight_oihw.permute(2, 3, 1, 0)
    return out.view(9 * cin, -1)


def unpack_kernel(packed: torch.Tensor, cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_kernel`: (9*Cin, n_pad) -> OIHW (cout, Cin, 3, 3)."""
    cin = packed.shape[0] // 9
    return packed[:, :cout].reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def pack_net(win0, b0, wjs, bj0, dtype: torch.dtype, *, fused: bool = True) -> PackedNet:
    """Pack OIHW kernels and biases, detached, for :func:`fused_coupling`,
    in the numerics ``fused`` selects."""
    return PackedNet(
        pack_kernel(win0.detach(), dtype),
        b0.detach().float().contiguous(),
        tuple(pack_kernel(w.detach(), dtype) for w in wjs),
        bj0.detach().float().contiguous(),
        fused,
    )


def fused_coupling_reference(
    xa: torch.Tensor,
    xb: torch.Tensor,
    h0c: torch.Tensor | None,
    net: PackedNet,
    *,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused coupling (NHWC, f32 accumulation),
    in the numerics ``net.fused`` selects.

    xa (B,H,W,ca), xb (B,H,W,cb); h0c (1 or B, H, W, width) or None.
    Returns (y (B,H,W,ca+cb) f32, ld (B,) f32; ld negated in reverse).
    """
    nd = net.net_dtype
    L, growth = net.layers, net.growth
    ca = xa.shape[-1]
    tgt_widths = [growth] * L + [2 * ca]

    def r(v):  # the default path's rounding to the net dtype
        return v if net.fused else v.to(nd).float()

    def conv(p, w_packed, cout):
        k = unpack_kernel(w_packed[:, :cout].to(nd).float(), cout)
        x = p.to(nd).float().permute(0, 3, 1, 2)
        return r(F.conv2d(x, k, padding=1).permute(0, 2, 3, 1))

    h0 = r(conv(xb, net.win0, net.width) + r(net.b0))
    if h0c is not None:
        h0 = r(h0 + h0c.to(nd).float())
    feat = torch.relu(h0)
    accs: list = [None] * (L + 1)
    for j, cout in enumerate(net.couts):
        yj = conv(feat, net.wjs[j], cout)
        if j == 0:
            yj = r(yj + r(net.bj0))
        off = 0
        for t in range(j, L + 1):
            sl = yj[..., off : off + tgt_widths[t]]
            off += tgt_widths[t]
            accs[t] = sl if accs[t] is None else r(accs[t] + sl)
        if j < L:
            feat = torch.relu(accs[j])
    raw, t_shift = accs[L][..., :ca], accs[L][..., ca:]
    log_s = F.logsigmoid(raw + _SCALE_SHIFT)
    xa32 = xa.float()
    if reverse:
        ya = xa32 * torch.exp(-log_s) - t_shift
    else:
        ya = (xa32 + t_shift) * torch.exp(log_s)
    y = torch.cat([ya, xb.float()], dim=-1)
    ld = log_s.sum(dim=(-3, -2, -1))
    return y, (-ld if reverse else ld)


def _entry(dtype: torch.dtype):
    """The kernel's C entry point for net dtype ``dtype``, with its ctypes
    signature (every pointer and the stream as ``c_void_p``)."""
    from tpuflow_torch.kernels import _build

    lib = _build.load("coupling_fused")
    fn = getattr(lib, _ENTRY[dtype])
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        scratch = [ptr, ptr] if dtype == torch.float32 else [ptr, ptr, ptr]
        fn.argtypes = ([ptr, ptr, ptr, i32, ptr, ptr, ctypes.POINTER(ptr), ptr, ptr, ptr]
                       + scratch + [i32] * 10 + [ctypes.POINTER(i32), ptr])
        fn.restype = ctypes.c_int
        if lib.tpf_plan_ints() != len(TilePlan._fields):
            raise RuntimeError("coupling_fused: the kernel's Plan struct does not match "
                               "TilePlan")
    return fn


def _check_cuda_args(xa, xb, h0c, net: PackedNet) -> None:
    dev = xa.device
    tensors = {"xa": xa, "xb": xb, "win0": net.win0, "b0": net.b0, "bj0": net.bj0}
    tensors.update({f"wjs[{j}]": w for j, w in enumerate(net.wjs)})
    if h0c is not None:
        tensors["h0c"] = h0c
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"fused_coupling: {name} on {t.device}, xa on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_coupling: {name} must be contiguous")
        if t.requires_grad:
            raise ValueError(
                f"fused_coupling: {name} requires grad; differentiate through "
                "fused_coupling_autograd"
            )
    nd = net.net_dtype
    if nd not in _ENTRY:
        raise TypeError(f"fused_coupling: net dtype {nd} not supported")
    for name in ("xa", "xb", "b0", "bj0"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"fused_coupling: {name} must be float32")
    for j, w in enumerate(net.wjs):
        if w.dtype != nd:
            raise TypeError(f"fused_coupling: wjs[{j}] is {w.dtype}, net dtype {nd}")
    if xa.dim() != 4 or xb.dim() != 4 or xa.shape[:3] != xb.shape[:3]:
        raise ValueError(
            f"fused_coupling: xa {tuple(xa.shape)} and xb {tuple(xb.shape)} must "
            "be (B, H, W, c) with equal B, H, W"
        )
    b, h, w, ca = xa.shape
    cb = xb.shape[-1]
    width, growth, L = net.width, net.growth, net.layers
    if w > _MAX_W:
        raise ValueError(f"fused_coupling: W={w} exceeds the kernel's {_MAX_W}")
    if net.win0.shape != (9 * cb, _round_up(width, 8)):
        raise ValueError("fused_coupling: conv_in_0 weights do not match xb / width "
                         "(pack them with pack_net)")
    total0 = L * growth + 2 * ca
    if net.bj0.shape != (total0,):
        raise ValueError("fused_coupling: bj0 does not match joint_0's columns")
    for j, (wj, cout) in enumerate(zip(net.wjs, net.couts)):
        cin = width if j == 0 else growth
        if wj.shape != (9 * cin, _round_up(cout, 8)):
            raise ValueError(
                f"fused_coupling: wjs[{j}] shape {tuple(wj.shape)} != "
                f"{(9 * cin, _round_up(cout, 8))} (pack them with pack_net)"
            )
    if h0c is not None:
        if h0c.dtype != nd:
            raise TypeError(f"fused_coupling: h0c is {h0c.dtype}, net dtype {nd}")
        if h0c.dim() != 4 or h0c.shape[1:] != (h, w, width) or h0c.shape[0] not in (1, b):
            raise ValueError(
                f"fused_coupling: h0c shape {tuple(h0c.shape)} incompatible with "
                f"{(b, h, w, width)}"
            )


def fused_coupling(
    xa: torch.Tensor,
    xb: torch.Tensor,
    h0c: torch.Tensor | None,
    net: PackedNet,
    *,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused coupling: (y = [affine(xa), xb], logdet).

    xa (B,H,W,ca) and xb (B,H,W,cb) float32; h0c (1 or B, H, W, width) in
    the net dtype (the precomputed conv_in_1 of the conditioning) or None;
    ``net`` from :func:`pack_net`. Returns y (B,H,W,ca+cb) float32 and
    logdet (B,) float32, negated in reverse.

    CUDA tensors go to the kernel of the net dtype (or raise); CPU tensors
    take :func:`fused_coupling_reference`.
    """
    global launches
    if xa.device.type == "cpu":
        return fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
    if xa.device.type != "cuda":
        raise ValueError(f"fused_coupling: unsupported device {xa.device}")
    _check_cuda_args(xa, xb, h0c, net)
    nd = net.net_dtype
    fn = _entry(nd)
    b, h, w, ca = xa.shape
    cb = xb.shape[-1]
    width, growth, L = net.width, net.growth, net.layers
    dev = xa.device
    y = torch.empty((b, h, w, ca + cb), dtype=torch.float32, device=dev)
    ld = torch.empty((b,), dtype=torch.float32, device=dev)
    npix = b * h * w
    if nd == torch.bfloat16:
        plan = _launch(b, h, w, ca, cb, width, growth, L)
        feat = torch.empty(npix * plan.feat, dtype=nd, device=dev)
        acc = torch.empty(npix * plan.acc, dtype=torch.float32, device=dev)
        part = torch.empty(b * plan.tiles, dtype=torch.float32, device=dev)
        scratch, layout = (feat.data_ptr(), acc.data_ptr(), part.data_ptr()), plan.plans
    else:
        feat = torch.empty(npix * (width + L * growth), dtype=nd, device=dev)
        acc = torch.empty(npix * (L * growth + 2 * ca), dtype=torch.float32, device=dev)
        scratch = (feat.data_ptr(), acc.data_ptr())
        layout = (ctypes.c_int * (L + 2))(net.win0.shape[1], *[wj.shape[1] for wj in net.wjs])
    wjs = (ctypes.c_void_p * (L + 1))(*[wj.data_ptr() for wj in net.wjs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            xa.data_ptr(), xb.data_ptr(),
            None if h0c is None else h0c.data_ptr(),
            0 if h0c is None else h0c.shape[0],
            net.win0.data_ptr(), net.b0.data_ptr(), wjs, net.bj0.data_ptr(),
            y.data_ptr(), ld.data_ptr(), *scratch,
            b, h, w, ca, cb, width, growth, L, int(reverse), int(not net.fused), layout,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_coupling kernel launch failed: cudaError {err}")
    launches += 1
    return y, ld


class _FusedCoupling(torch.autograd.Function):
    """See :func:`fused_coupling_autograd`."""

    @staticmethod
    def forward(ctx, xa, xb, h0c, dtype, fused, reverse, win0, b0, bj0, *wjs):
        ctx.dtype, ctx.fused, ctx.reverse = dtype, fused, reverse
        ctx.save_for_backward(xa, xb, h0c, win0, b0, bj0, *wjs)
        net = pack_net(win0, b0, wjs, bj0, dtype, fused=fused)
        return fused_coupling(
            xa.detach(), xb.detach(), None if h0c is None else h0c.detach(), net,
            reverse=reverse,
        )

    @staticmethod
    def backward(ctx, gy, gld):
        saved = ctx.saved_tensors
        # needs_input_grad follows forward's arguments; drop dtype, fused,
        # reverse.
        needs = ctx.needs_input_grad[:3] + ctx.needs_input_grad[6:]
        with torch.enable_grad():
            live = [None if a is None else a.detach().requires_grad_(n)
                    for a, n in zip(saved, needs)]
            xa, xb, h0c, win0, b0, bj0, *wjs = live
            net = PackedNet(
                pack_kernel(win0, ctx.dtype), b0.float(),
                tuple(pack_kernel(w, ctx.dtype) for w in wjs), bj0.float(), ctx.fused,
            )
            y, ld = fused_coupling_reference(xa, xb, h0c, net, reverse=ctx.reverse)
            wrt = [a for a, n in zip(live, needs) if n and a is not None]
            grads = iter(torch.autograd.grad((y, ld), wrt, (gy, gld), allow_unused=True))
        out = [next(grads) if n and a is not None else None for a, n in zip(live, needs)]
        return (*out[:3], None, None, None, *out[3:])


def fused_coupling_autograd(
    xa: torch.Tensor,
    xb: torch.Tensor,
    h0c: torch.Tensor | None,
    win0: torch.Tensor,
    b0: torch.Tensor,
    wjs,
    bj0: torch.Tensor,
    dtype: torch.dtype,
    *,
    fused: bool = True,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_coupling` from the OIHW parameters (conv_in_0 kernel
    ``win0`` and bias ``b0``, joint kernels ``wjs``, joint_0 bias ``bj0``),
    packed in net dtype ``dtype`` and numerics ``fused`` inside the call;
    differentiable in xa, xb, h0c and every parameter. The forward launches
    the kernel on CUDA tensors; the backward differentiates the plain
    version in the same numerics."""
    return _FusedCoupling.apply(xa, xb, h0c, dtype, fused, reverse, win0, b0, bj0, *wjs)
