"""Invertible 1x1 convolution, LU-parameterised.

Counterpart of ``tpuflow/flows/inv1x1.py``: y[n,h,w,:] = x[n,h,w,:] @ W
with W = P @ L @ (U + diag(sign_s * exp(log_s))), logdet =
H*W*sum(log_s). The map contracts over channels as ``x @ W``, so seen as
an NCHW 1x1 conv its weight would be W transposed; here it stays a
matmul on the channel axis of the NHWC tensor. P and sign_s are fixed
buffers, as in the JAX package's ``buffers`` collection.
"""

from __future__ import annotations

import torch
from torch import nn


def compute_w_inv(
    l_free: torch.Tensor,
    u_free: torch.Tensor,
    log_s: torch.Tensor,
    p: torch.Tensor,
    sign_s: torch.Tensor,
) -> torch.Tensor:
    """W^{-1} = U^{-1} L^{-1} P^T from the LU factors, by two triangular
    solves in float64 (computed once per rollout, so the extra precision
    is free), returned as float32."""
    c = log_s.shape[0]
    f64 = dict(dtype=torch.float64, device=log_s.device)
    eye = torch.eye(c, **f64)
    l_mat = torch.tril(l_free.to(torch.float64), -1) + eye
    u_mat = torch.triu(u_free.to(torch.float64), 1) + torch.diag(
        sign_s.to(torch.float64) * torch.exp(log_s.to(torch.float64))
    )
    l_inv = torch.linalg.solve_triangular(l_mat, eye, upper=False, unitriangular=True)
    u_inv = torch.linalg.solve_triangular(u_mat, eye, upper=True)
    return (u_inv @ (l_inv @ p.to(torch.float64).T)).to(torch.float32)


class InvConv1x1LU(nn.Module):
    def __init__(
        self,
        channels: int,
        *,
        generator: torch.Generator | None = None,
        device: torch.device | None = None,
    ):
        super().__init__()
        c = channels
        if generator is not None:
            # One random rotation, factored once (Flax init counterpart).
            q, _ = torch.linalg.qr(torch.randn(c, c, generator=generator))
            p0, l0, u0 = torch.linalg.lu(q)
            s0 = torch.diagonal(u0)
        else:
            p0, l0, u0, s0 = torch.eye(c), torch.eye(c), torch.eye(c), torch.ones(c)
        self.l = nn.Parameter(torch.tril(l0, -1).to(device))
        self.u = nn.Parameter(torch.triu(u0, 1).to(device))
        self.log_s = nn.Parameter(torch.log(torch.abs(s0)).to(device))
        self.register_buffer("p", p0.to(device))
        self.register_buffer("sign_s", torch.sign(s0).to(device))

    def w_inv(self) -> torch.Tensor:
        return compute_w_inv(self.l, self.u, self.log_s, self.p, self.sign_s)

    def forward(
        self,
        x: torch.Tensor,
        *,
        reverse: bool = False,
        w_inv: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (N, H, W, C). ``w_inv`` (from :meth:`w_inv`) skips the
        triangular solves in reverse."""
        n, h, w, c = x.shape
        logdet = (h * w * self.log_s.sum()).expand(n)
        x32 = x.float()
        if reverse:
            if w_inv is None:
                w_inv = self.w_inv()
            return x32 @ w_inv, -logdet
        eye = torch.eye(c, device=x.device)
        l_mat = torch.tril(self.l, -1) + eye
        u_mat = torch.triu(self.u, 1) + torch.diag(self.sign_s * torch.exp(self.log_s))
        return x32 @ (self.p @ (l_mat @ u_mat)), logdet
