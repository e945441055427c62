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

Numerics. The port follows the fused semantics of the JAX package
(``xla_reference``, which is what ``use_pallas=True`` computes on a TPU):
every product of net-dtype operands accumulates in float32, and only the
relu features are rounded to the net dtype. The JAX package's default XLA
path at bfloat16 rounds each conv's output to bfloat16 instead. So at
float32 the port matches the JAX package tightly on every path, and at
bfloat16 it matches ``xla_reference`` but the default JAX path only
loosely. The plain version reproduces float32 accumulation of bfloat16
operands on the CPU by rounding inputs and weights to bfloat16 and then
convolving in float32: products of bfloat16 values are exact in float32.

Weights are packed (:func:`pack_net`): conv kernels as (9*Cin, Cout) in
the net dtype with rows ordered (dy, dx, cin), biases float32. A rollout
packs them once, detached, and calls :func:`fused_coupling` directly,
which refuses CUDA inputs that require grad.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

_SCALE_SHIFT = 2.0  # sigmoid(raw + 2): coupling starts near identity

# Kernel launches by fused_coupling since the last reset (a plain count:
# a run sets it to 0, drives the path, and reads it).
launches = 0

_ENTRY = {torch.float32: "tpf_fused_coupling_f32", torch.bfloat16: "tpf_fused_coupling_bf16"}
_MAX_W = 128  # widest row the kernel's shared-memory tile takes


class PackedNet(NamedTuple):
    """A coupling net's weights in the kernel's layout.

    win0: (9*cb, width) conv_in_0 kernel, net dtype; b0: (width,) f32;
    wjs: joint_j kernels (9*Cin_j, total_j), net dtype; bj0: (total_0,) f32.
    """

    win0: torch.Tensor
    b0: torch.Tensor
    wjs: tuple[torch.Tensor, ...]
    bj0: torch.Tensor

    @property
    def width(self) -> int:
        return self.win0.shape[1]

    @property
    def layers(self) -> int:
        return len(self.wjs) - 1

    @property
    def growth(self) -> int:
        if self.layers == 0:
            return 0
        return (self.wjs[0].shape[1] - self.wjs[-1].shape[1]) // self.layers

    @property
    def net_dtype(self) -> torch.dtype:
        return self.win0.dtype


def pack_kernel(weight_oihw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW 3x3 kernel -> (9*Cin, Cout) in ``dtype``, rows (dy, dx, cin)."""
    cout, cin = weight_oihw.shape[:2]
    return weight_oihw.permute(2, 3, 1, 0).reshape(9 * cin, cout).to(dtype).contiguous()


def pack_net(win0, b0, wjs, bj0, dtype: torch.dtype) -> PackedNet:
    """Pack OIHW kernels and biases, detached, for :func:`fused_coupling`."""
    return PackedNet(
        pack_kernel(win0.detach(), dtype),
        b0.detach().float().contiguous(),
        tuple(pack_kernel(w.detach(), dtype) for w in wjs),
        bj0.detach().float().contiguous(),
    )


def fused_coupling_reference(
    xa: torch.Tensor,
    xb: torch.Tensor,
    h0c: torch.Tensor | None,
    net: PackedNet,
    *,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused coupling (NHWC, f32 accumulation).

    xa (B,H,W,ca), xb (B,H,W,cb); h0c (1 or B, H, W, width) or None.
    Returns (y (B,H,W,ca+cb) f32, ld (B,) f32; ld negated in reverse).
    """
    nd = net.net_dtype
    L, growth = net.layers, net.growth
    ca = xa.shape[-1]
    tgt_widths = [growth] * L + [2 * ca]

    def conv(p, w_packed):
        cin = w_packed.shape[0] // 9
        k = w_packed.to(nd).float().reshape(3, 3, cin, -1).permute(3, 2, 0, 1)
        x = p.to(nd).float().permute(0, 3, 1, 2)
        return F.conv2d(x, k, padding=1).permute(0, 2, 3, 1)

    h0 = conv(xb, net.win0) + net.b0
    if h0c is not None:
        h0 = h0 + h0c.to(nd).float()
    feat = torch.relu(h0)
    accs: list = [None] * (L + 1)
    for j in range(L + 1):
        yj = conv(feat, net.wjs[j])
        if j == 0:
            yj = yj + net.bj0
        off = 0
        for t in range(j, L + 1):
            sl = yj[..., off : off + tgt_widths[t]]
            off += tgt_widths[t]
            accs[t] = sl if accs[t] is None else accs[t] + sl
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

    fn = getattr(_build.load("coupling_fused"), _ENTRY[dtype])
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ptr, ptr, ctypes.POINTER(ptr), ptr,
                       ptr, ptr, ptr, ptr] + [ctypes.c_int] * 9 + [ptr]
        fn.restype = ctypes.c_int
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
    if net.win0.shape != (9 * cb, width) or net.b0.shape != (width,):
        raise ValueError("fused_coupling: conv_in_0 weights do not match xb / width")
    total0 = L * growth + 2 * ca
    for j, wj in enumerate(net.wjs):
        cin = width if j == 0 else growth
        if wj.shape != (9 * cin, total0 - j * growth):
            raise ValueError(
                f"fused_coupling: wjs[{j}] shape {tuple(wj.shape)} != "
                f"{(9 * cin, total0 - j * growth)}"
            )
    if net.bj0.shape != (total0,):
        raise ValueError("fused_coupling: bj0 does not match joint_0's columns")
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

    CUDA tensors go to the kernel (or raise); CPU tensors take
    :func:`fused_coupling_reference`.
    """
    global launches
    if xa.device.type == "cpu":
        return fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
    if xa.device.type != "cuda":
        raise ValueError(f"fused_coupling: unsupported device {xa.device}")
    _check_cuda_args(xa, xb, h0c, net)
    fn = _entry(net.net_dtype)
    b, h, w, ca = xa.shape
    cb = xb.shape[-1]
    width, growth, L = net.width, net.growth, net.layers
    nd = net.net_dtype
    y = torch.empty((b, h, w, ca + cb), dtype=torch.float32, device=xa.device)
    ld = torch.empty((b,), dtype=torch.float32, device=xa.device)
    feat = torch.empty(b * h * w * (width + L * growth), dtype=nd, device=xa.device)
    acc = torch.empty(b * h * w * (L * growth + 2 * ca), dtype=torch.float32, device=xa.device)
    wjs = (ctypes.c_void_p * (L + 1))(*[wj.data_ptr() for wj in net.wjs])
    stream = torch.cuda.current_stream(xa.device).cuda_stream
    with torch.cuda.device(xa.device):
        err = fn(
            xa.data_ptr(), xb.data_ptr(),
            None if h0c is None else h0c.data_ptr(),
            0 if h0c is None else h0c.shape[0],
            net.win0.data_ptr(), net.b0.data_ptr(), wjs, net.bj0.data_ptr(),
            y.data_ptr(), ld.data_ptr(), feat.data_ptr(), acc.data_ptr(),
            b, h, w, ca, cb, width, growth, L, int(reverse), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_coupling kernel launch failed: cudaError {err}")
    launches += 1
    return y, ld


class _FusedCoupling(torch.autograd.Function):
    """See :func:`fused_coupling_autograd`."""

    @staticmethod
    def forward(ctx, xa, xb, h0c, dtype, reverse, win0, b0, bj0, *wjs):
        ctx.dtype, ctx.reverse = dtype, reverse
        ctx.save_for_backward(xa, xb, h0c, win0, b0, bj0, *wjs)
        net = pack_net(win0, b0, wjs, bj0, dtype)
        return fused_coupling(
            xa.detach(), xb.detach(), None if h0c is None else h0c.detach(), net,
            reverse=reverse,
        )

    @staticmethod
    def backward(ctx, gy, gld):
        saved = ctx.saved_tensors
        # needs_input_grad follows forward's arguments; drop dtype, reverse.
        needs = ctx.needs_input_grad[:3] + ctx.needs_input_grad[5:]
        with torch.enable_grad():
            live = [None if a is None else a.detach().requires_grad_(n)
                    for a, n in zip(saved, needs)]
            xa, xb, h0c, win0, b0, bj0, *wjs = live
            net = PackedNet(
                pack_kernel(win0, ctx.dtype), b0.float(),
                tuple(pack_kernel(w, ctx.dtype) for w in wjs), bj0.float(),
            )
            y, ld = fused_coupling_reference(xa, xb, h0c, net, reverse=ctx.reverse)
            wrt = [a for a, n in zip(live, needs) if n and a is not None]
            grads = iter(torch.autograd.grad((y, ld), wrt, (gy, gld), allow_unused=True))
        out = [next(grads) if n and a is not None else None for a, n in zip(live, needs)]
        return (*out[:3], None, None, *out[3:])


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
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_coupling` from the OIHW parameters (conv_in_0 kernel
    ``win0`` and bias ``b0``, joint kernels ``wjs``, joint_0 bias ``bj0``),
    packed in net dtype ``dtype`` inside the call; differentiable in xa,
    xb, h0c and every parameter. The forward launches the kernel on CUDA
    tensors; the backward differentiates the plain version."""
    return _FusedCoupling.apply(xa, xb, h0c, dtype, reverse, win0, b0, bj0, *wjs)
