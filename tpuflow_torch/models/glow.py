"""Multi-scale conditional Glow: L scales x K steps of flow.

Counterpart of ``tpuflow/models/glow.py``. Each scale squeezes 2x, runs K
steps of (ActNorm -> invertible 1x1 -> conditional affine coupling), then
factors out half the channels under a learned conditional prior; the
last scale puts a conditional base prior on the whole remaining latent.
Flow tensors are NHWC and the flow arithmetic is float32; only the
coupling and prior networks run in the net dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpuflow_torch.flows import (
    ActNorm,
    AffineCoupling,
    ConditionalPrior,
    ConditionalSplit,
    InvConv1x1LU,
    squeeze2d,
    unsqueeze2d,
)
from tpuflow_torch.kernels.coupling_fused import PackedNet


def per_scale_temperature(temperature, n_scales: int) -> list:
    """A scalar tau (float or 0-d tensor) for every scale, or an
    (n_scales,) vector whose entry l is scale l's tau (l = 0 the finest
    split)."""
    if isinstance(temperature, (int, float)):
        return [float(temperature)] * n_scales
    t = torch.as_tensor(temperature)
    if t.dim() == 0:
        return [t] * n_scales
    if t.shape != (n_scales,):
        raise ValueError(
            f"per-scale temperature must have shape ({n_scales},), got {tuple(t.shape)}"
        )
    return [t[l] for l in range(n_scales)]


class GlowStep(nn.Module):
    """One step of flow: ActNorm -> InvConv1x1(LU) -> AffineCoupling."""

    def __init__(self, channels, cond_channels, *, width, layers, growth_rate,
                 dtype, use_pallas=False, generator=None, device=None):
        super().__init__()
        self.actnorm = ActNorm(channels, device=device)
        self.invconv = InvConv1x1LU(channels, generator=generator, device=device)
        self.coupling = AffineCoupling(
            channels, cond_channels, width=width, layers=layers,
            growth_rate=growth_rate, dtype=dtype, use_pallas=use_pallas,
            generator=generator, device=device,
        )

    def forward(self, x, cond, *, reverse=False, w_inv=None, packed=None):
        if reverse:
            x, ld2 = self.coupling(x, cond, reverse=True, packed=packed)
            x, ld1 = self.invconv(x, reverse=True, w_inv=w_inv)
            x, ld0 = self.actnorm(x, reverse=True)
        else:
            x, ld0 = self.actnorm(x)
            x, ld1 = self.invconv(x)
            x, ld2 = self.coupling(x, cond, packed=packed)
        return x, ld0 + ld1 + ld2


class MultiScaleGlow(nn.Module):
    """forward: x, conds -> (latents, logdet, logp); reverse: conds and
    given latents (reconstruction) or drawn latents (generation) -> (x,
    logp of the latents used)."""

    def __init__(
        self,
        *,
        n_scales: int = 3,
        n_steps: int = 8,
        in_channels: int = 3,
        cond_channels: int = 32,
        width: int = 64,
        layers: int = 3,
        growth_rate: int = 32,
        dtype: torch.dtype = torch.bfloat16,
        use_pallas: bool = False,
        z_clip: float = 0.0,
        generator: torch.Generator | None = None,
        device: torch.device | None = None,
    ):
        super().__init__()
        self.n_scales, self.n_steps = n_scales, n_steps
        c = in_channels
        for l in range(n_scales):
            c *= 4
            for k in range(n_steps):
                self.add_module(
                    f"scale{l}_step{k}",
                    GlowStep(c, cond_channels, width=width, layers=layers,
                             growth_rate=growth_rate, dtype=dtype,
                             use_pallas=use_pallas, generator=generator, device=device),
                )
            if l < n_scales - 1:
                self.add_module(
                    f"split{l}",
                    ConditionalSplit(c, cond_channels, dtype=dtype, z_clip=z_clip, device=device),
                )
                c //= 2
        self.base_prior = ConditionalPrior(c, cond_channels, dtype=dtype, z_clip=z_clip, device=device)

    def step(self, l: int, k: int) -> GlowStep:
        return getattr(self, f"scale{l}_step{k}")

    def split(self, l: int) -> ConditionalSplit:
        return getattr(self, f"split{l}")

    def pack_couplings(self) -> list[list[PackedNet]]:
        """Every coupling net's packed weights and numerics, [scale][step];
        packed once per rollout, outside the time loop."""
        return [[self.step(l, k).coupling.net.pack() for k in range(self.n_steps)]
                for l in range(self.n_scales)]

    def forward(self, x: torch.Tensor, conds: Sequence[torch.Tensor]):
        n = x.shape[0]
        logdet = torch.zeros(n, device=x.device)
        logp = torch.zeros(n, device=x.device)
        latents = []
        h = x
        for l in range(self.n_scales):
            h = squeeze2d(h)
            for k in range(self.n_steps):
                h, ld = self.step(l, k)(h, conds[l])
                logdet = logdet + ld
            if l < self.n_scales - 1:
                h, drop, lp = self.split(l)(h, conds[l])
                latents.append(drop)
            else:
                _, lp = self.base_prior(h, conds[l])
                latents.append(h)
            logp = logp + lp
        return latents, logdet, logp

    def reverse(
        self,
        conds: Sequence[torch.Tensor],
        *,
        latents: Sequence[torch.Tensor] | None = None,
        temperature=1.0,
        generator: torch.Generator | None = None,
        eps: Sequence[torch.Tensor] | None = None,
        inv_caches: Sequence[Sequence[torch.Tensor]] | None = None,
        packs: Sequence[Sequence[PackedNet]] | None = None,
    ):
        """``latents`` reconstructs; otherwise latents are drawn at
        ``temperature`` (scalar or per-scale) from ``generator``, or
        from ``eps[l]``, the standard-normal draws of scale l."""
        L = self.n_scales
        taus = per_scale_temperature(temperature, L)

        def draw(l):
            return dict(temperature=taus[l], generator=generator,
                        eps=None if eps is None else eps[l])

        if latents is not None:
            h = latents[-1]
            _, logp = self.base_prior(h, conds[L - 1])
        else:
            h, neg_lp = self.base_prior.reverse(conds[L - 1], **draw(L - 1))
            logp = -neg_lp
        for l in range(L - 1, -1, -1):
            if l < L - 1:
                if latents is not None:
                    h, neg_lp = self.split(l).reverse(h, conds[l], drop=latents[l])
                else:
                    h, neg_lp = self.split(l).reverse(h, conds[l], **draw(l))
                logp = logp - neg_lp
            for k in range(self.n_steps - 1, -1, -1):
                h, _ = self.step(l, k)(
                    h, conds[l], reverse=True,
                    w_inv=None if inv_caches is None else inv_caches[l][k],
                    packed=None if packs is None else packs[l][k],
                )
            h = unsqueeze2d(h)
        return h, logp
