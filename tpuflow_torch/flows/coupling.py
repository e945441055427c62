"""Conditional affine coupling with a dense-block coupling network.

Counterpart of ``tpuflow/flows/coupling.py``. ``DenseBlockNet`` holds the
parameters of the JAX package's concat-free, output-fused dense block,
one parameter per Flax leaf (``conv_in_0``, ``conv_in_1``, ``joint_j``);
``AffineCoupling`` runs the whole coupling through the fused coupling of
:mod:`tpuflow_torch.kernels.coupling_fused`: the CUDA kernel on a GPU,
its plain version on the CPU. Given packed weights (a rollout packs them
once) it calls the registered operator ``tpuflow_torch::fused_coupling``
(:mod:`tpuflow_torch.kernels.ops`), which ``torch.export`` can trace;
otherwise it goes through ``fused_coupling_autograd``, which packs the
parameters inside the call so that gradients reach every one of them.
Its numerics are the JAX package's fused path (see that module's
docstring).
"""

from __future__ import annotations

import torch
from torch import nn

from tpuflow_torch.flows.layout import conv_nhwc, lecun_normal_
from tpuflow_torch.kernels.coupling_fused import PackedNet, fused_coupling_autograd, pack_net
from tpuflow_torch.kernels.ops import fused_coupling


class _Conv3x3Params(nn.Module):
    """A 3x3 conv's parameters: ``weight`` (out, in, 3, 3) f32, optional
    ``bias`` (out,)."""

    def __init__(self, in_features, features, use_bias, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features, 3, 3, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None


class DenseBlockNet(nn.Module):
    """Parameters of the dense-block coupling net.

    Sources (xb [, cond]) -> width (h0); then sources h0, g_1, ..., g_L
    each emit one joint conv whose column blocks are that source's
    contributions to every later target (growth layers j..L-1 and the
    ``out_channels`` head). ``joint_0`` carries the one bias per target.
    With a generator, kernels get Flax's ``lecun_normal`` and the head
    columns start at zero (each coupling starts at the identity).
    """

    def __init__(
        self,
        in_channels: int,
        cond_channels: int | None,
        *,
        width: int = 64,
        layers: int = 3,
        growth_rate: int = 32,
        out_channels: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        device: torch.device | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        tgt_widths = [growth_rate] * layers + [out_channels]
        self.conv_in_0 = _Conv3x3Params(in_channels, width, True, device)
        self.conv_in_1 = (
            _Conv3x3Params(cond_channels, width, False, device)
            if cond_channels is not None else None
        )
        for j in range(layers + 1):
            cin = width if j == 0 else growth_rate
            total = sum(tgt_widths[j:])
            self.add_module(f"joint_{j}", _Conv3x3Params(cin, total, j == 0, device))
        self.layers = layers
        if generator is not None:
            for conv in self._convs():
                lecun_normal_(conv.weight, generator)
            with torch.no_grad():
                for j in range(layers + 1):
                    getattr(self, f"joint_{j}").weight[-out_channels:].zero_()

    def joints(self) -> list[_Conv3x3Params]:
        return [getattr(self, f"joint_{j}") for j in range(self.layers + 1)]

    def _convs(self):
        convs = [self.conv_in_0]
        if self.conv_in_1 is not None:
            convs.append(self.conv_in_1)
        return convs + self.joints()

    def pack(self) -> PackedNet:
        """The kernel's weight layout (net dtype kernels, f32 biases)."""
        joints = self.joints()
        return pack_net(
            self.conv_in_0.weight, self.conv_in_0.bias,
            [j.weight for j in joints], joints[0].bias, self.dtype,
        )

    def cond_conv(self, cond: torch.Tensor) -> torch.Tensor:
        """h0c = conv_in_1(cond) in the net dtype, computed outside the
        fused kernel (batch-1 conditioning stays batch-1)."""
        return conv_nhwc(cond, self.conv_in_1.weight, None, self.dtype)


class AffineCoupling(nn.Module):
    """y_a = (x_a + t) * sigmoid(raw + 2), (raw, t) = Net([x_b, cond]);
    y = [y_a, x_b]. Reverse inverts it with the same net output."""

    def __init__(
        self,
        channels: int,
        cond_channels: int | None,
        *,
        width: int = 64,
        layers: int = 3,
        growth_rate: int = 32,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        device: torch.device | None = None,
    ):
        super().__init__()
        self.ca = channels // 2
        self.net = DenseBlockNet(
            channels - self.ca, cond_channels, width=width, layers=layers,
            growth_rate=growth_rate, out_channels=2 * self.ca, dtype=dtype,
            generator=generator, device=device,
        )

    def forward(
        self,
        x: torch.Tensor,
        cond: torch.Tensor | None = None,
        *,
        reverse: bool = False,
        packed: PackedNet | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """x (N, H, W, C). With ``packed`` (from ``net.pack()``, detached)
        the call skips the weight packing and carries no gradient;
        without it, it is differentiable in x, cond and every parameter."""
        xa = x[..., : self.ca].float().contiguous()
        xb = x[..., self.ca :].float().contiguous()
        h0c = None if cond is None else self.net.cond_conv(cond).contiguous()
        if packed is not None:
            return fused_coupling(xa, xb, h0c, packed, reverse=reverse)
        net, joints = self.net, self.net.joints()
        return fused_coupling_autograd(
            xa, xb, h0c, net.conv_in_0.weight, net.conv_in_0.bias,
            [j.weight for j in joints], joints[0].bias, net.dtype, reverse=reverse,
        )
