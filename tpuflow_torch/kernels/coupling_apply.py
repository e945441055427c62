"""Affine-coupling apply + logdet reduction: K1 of the JAX package, on Hopper.

Counterpart of ``tpuflow/kernels/coupling_ops.py`` (the entry point
:func:`coupling_apply` and its plain version) and
``tpuflow/kernels/coupling_pallas.py`` (the kernel and its closed-form
gradient). With ``s = sigmoid(raw + 2)``:

    forward: y = (x + t) * s,   ld =  sum over (H, W, C) of log s
    reverse: y = x / s - t,     ld = -sum over (H, W, C) of log s

* :func:`coupling_apply` is the entry point. On CUDA tensors it always
  launches the hand-written kernel in ``csrc/coupling_apply.cu`` (built by
  ``_build.py`` with nvcc, bound with ctypes) or raises; ``use_pallas`` is
  accepted for signature parity and selects nothing. On CPU tensors it
  runs :func:`coupling_apply_reference`.
* :func:`coupling_apply_reference` is the plain PyTorch version, the
  counterpart of the JAX package's ``_xla_coupling_apply``, including the
  ``hwnc`` reduction axes. The kernel is held against it on the card.
* Gradients: both devices go through one ``torch.autograd.Function``
  whose backward is the closed form of ``coupling_pallas.py:117-134`` in
  torch ops, as the JAX package's backward is XLA and not a kernel.

No model module calls this entry point: as in the JAX package, the
coupling layers run the fused coupling (``coupling_fused``) instead.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_SCALE_SHIFT = 2.0  # sigmoid(raw + 2): coupling starts near identity

# Kernel launches by coupling_apply since the last reset (a plain count:
# a run sets it to 0, drives the path, and reads it).
launches = 0


def _field_axes(layout: str) -> tuple[int, int, int]:
    if layout not in ("nhwc", "hwnc"):
        raise ValueError(f"layout must be 'nhwc' or 'hwnc', got {layout!r}")
    return (-4, -3, -1) if layout == "hwnc" else (-3, -2, -1)


def coupling_apply_reference(
    x: torch.Tensor,
    raw: torch.Tensor,
    t: torch.Tensor,
    *,
    reverse: bool = False,
    layout: str = "nhwc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (y f32, ld f32 shaped like the batch axes;
    negated in reverse). x, raw, t are (..., H, W, C), or (..., H, W, N, C)
    under ``layout="hwnc"``."""
    axes = _field_axes(layout)
    x, raw, t = x.float(), raw.float(), t.float()
    log_s = F.logsigmoid(raw + _SCALE_SHIFT)
    ld = log_s.sum(dim=axes)
    if reverse:
        return x * torch.exp(-log_s) - t, -ld
    return (x + t) * torch.exp(log_s), ld


def _entry():
    from tpuflow_torch.kernels import _build

    fn = _build.load("coupling_apply").tpf_coupling_apply
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, raw: torch.Tensor, t: torch.Tensor, reverse: bool):
    """The kernel on (..., H, W, C) float32 CUDA tensors of one shape:
    rows are the flattened leading axes, D = H*W*C."""
    global launches
    lead, d = x.shape[:-3], x.shape[-3] * x.shape[-2] * x.shape[-1]
    x2, raw2, t2 = (a.reshape(-1, d).contiguous() for a in (x, raw, t))
    rows = x2.shape[0]
    y = torch.empty_like(x2)
    ld = torch.empty(rows, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _entry()(x2.data_ptr(), raw2.data_ptr(), t2.data_ptr(), y.data_ptr(),
                       ld.data_ptr(), rows, d, int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"coupling_apply kernel launch failed: cudaError {err}")
    launches += 1
    ld = ld.reshape(lead)
    return y.reshape(x.shape), (-ld if reverse else ld)


class _CouplingApply(torch.autograd.Function):
    """(x, raw, t) nhwc float32 -> (y, signed ld); the kernel on CUDA, the
    plain version on the CPU; closed-form backward in torch ops."""

    @staticmethod
    def forward(ctx, x, raw, t, reverse):
        ctx.reverse = reverse
        ctx.save_for_backward(x, raw, t)
        if x.device.type == "cuda":
            return _launch(x, raw, t, reverse)
        return coupling_apply_reference(x, raw, t, reverse=reverse)

    @staticmethod
    def backward(ctx, gy, gld):
        x, raw, t = ctx.saved_tensors
        # The raw sum of log s gets +gld forward and -gld in reverse.
        gld_b = (-gld if ctx.reverse else gld)[..., None, None, None]
        s = torch.sigmoid(raw + _SCALE_SHIFT)
        one_m_s = 1.0 - s
        if ctx.reverse:
            gx = gy / s
            gt = -gy
            graw = (-gy * x / s + gld_b) * one_m_s
        else:
            gx = gy * s
            gt = gy * s
            graw = (gy * (x + t) * s + gld_b) * one_m_s
        return gx, graw, gt, None


def coupling_apply(
    x: torch.Tensor,
    raw: torch.Tensor,
    t: torch.Tensor,
    *,
    reverse: bool = False,
    use_pallas: bool = False,
    layout: str = "nhwc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine-coupling apply + logdet, the JAX package's signature and
    sign convention: (y f32, ld f32 shaped like the batch axes; negated in
    reverse). x, raw, t are (..., H, W, C), or (..., H, W, N, C) under
    ``layout="hwnc"``. Differentiable in x, raw and t.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version. ``use_pallas`` selects nothing (see the module docstring).
    """
    del use_pallas
    _field_axes(layout)
    if not (x.shape == raw.shape == t.shape) or x.dim() < (4 if layout == "hwnc" else 3):
        raise ValueError(
            f"coupling_apply: x {tuple(x.shape)}, raw {tuple(raw.shape)} and t "
            f"{tuple(t.shape)} must share one (..., H, W, C) shape"
        )
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"coupling_apply: unsupported device {dev}")
    if raw.device != dev or t.device != dev:
        raise ValueError(f"coupling_apply: x on {dev}, raw on {raw.device}, t on {t.device}")
    x, raw, t = x.float(), raw.float(), t.float()
    if layout == "hwnc":
        # (..., H, W, N, C) -> (..., N, H, W, C): rows are per member.
        x, raw, t = (a.movedim(-2, -4) for a in (x, raw, t))
        y, ld = _CouplingApply.apply(x, raw, t, reverse)
        return y.movedim(-4, -2), ld
    return _CouplingApply.apply(x, raw, t, reverse)
