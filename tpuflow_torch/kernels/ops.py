"""K2 as a registered PyTorch operator: ``torch.ops.tpuflow_torch.fused_coupling``.

The fused coupling (:mod:`tpuflow_torch.kernels.coupling_fused`) launches
its kernel through ``ctypes``, which ``torch.export`` cannot trace. This
module registers it with ``torch.library.custom_op``, so an exported
program holds one node per coupling and calls the kernel when it runs:

  * on CUDA tensors the operator runs :func:`coupling_fused.fused_coupling`
    (the kernel is launched or the call raises, and ``launches`` counts);
  * on CPU tensors it runs :func:`coupling_fused.fused_coupling_reference`;
  * the fake implementation gives an exported program its output shapes:
    y (B, H, W, ca + cb) and ld (B,), float32, on the inputs' device.

Any other device has no implementation and raises. The operator's
arguments are a :class:`PackedNet`'s fields, flattened; the net dtype,
width, growth and layers come from the tensors, as the ``PackedNet``
properties derive them. Importing this module registers the operator; a
program that ``torch.export.load`` reads must import it first.

The operator carries no gradient: the rollout's packed path calls it
(under ``torch.no_grad`` or ``torch.inference_mode``), and training goes
through ``coupling_fused.fused_coupling_autograd``.
"""

from typing import Optional

import torch

from tpuflow_torch.kernels import coupling_fused
from tpuflow_torch.kernels.coupling_fused import PackedNet


def _net(win0, b0, wjs, bj0) -> PackedNet:
    return PackedNet(win0, b0, tuple(wjs), bj0)


@torch.library.custom_op("tpuflow_torch::fused_coupling", mutates_args=(), device_types="cuda")
def fused_coupling_op(
    xa: torch.Tensor,
    xb: torch.Tensor,
    h0c: Optional[torch.Tensor],
    win0: torch.Tensor,
    b0: torch.Tensor,
    wjs: list[torch.Tensor],
    bj0: torch.Tensor,
    reverse: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused coupling on CUDA tensors: the kernel, or raise."""
    return coupling_fused.fused_coupling(xa, xb, h0c, _net(win0, b0, wjs, bj0), reverse=reverse)


@fused_coupling_op.register_kernel("cpu")
def _cpu(xa, xb, h0c, win0, b0, wjs, bj0, reverse):
    return coupling_fused.fused_coupling_reference(xa, xb, h0c, _net(win0, b0, wjs, bj0),
                                                   reverse=reverse)


@fused_coupling_op.register_fake
def _fake(xa, xb, h0c, win0, b0, wjs, bj0, reverse):
    b, h, w, ca = xa.shape
    y = xa.new_empty((b, h, w, ca + xb.shape[-1]), dtype=torch.float32)
    return y, xa.new_empty((b,), dtype=torch.float32)


def fused_coupling(
    xa: torch.Tensor,
    xb: torch.Tensor,
    h0c: torch.Tensor | None,
    net: PackedNet,
    *,
    reverse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`coupling_fused.fused_coupling`'s signature, through the
    registered operator."""
    return torch.ops.tpuflow_torch.fused_coupling(
        xa, xb, h0c, net.win0, net.b0, list(net.wjs), net.bj0, reverse)
