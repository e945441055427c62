"""Conditional ConvLSTM cell, the recurrence of TM-Glow.

Counterpart of ``tpuflow/models/conv_lstm.py``: gates = W_x * x + W_h * h
(two 3x3 convs in the net dtype, so a batch-1 input broadcasts against a
member-batched hidden state), split in the order i, f, g, o, with a
forget bias of 1.0; the cell state is float32.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuflow_torch.flows.layout import LayoutConv

State = tuple[torch.Tensor, torch.Tensor]  # (h, c), float32


class ConvLSTMCell(nn.Module):
    def __init__(
        self,
        in_channels: int,
        hidden: int,
        *,
        forget_bias: float = 1.0,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | None = None,
    ):
        super().__init__()
        self.forget_bias = forget_bias
        self.gates_x = LayoutConv(in_channels, 4 * hidden, 3, dtype=dtype, device=device)
        self.gates_h = LayoutConv(hidden, 4 * hidden, 3, use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, state: State) -> tuple[torch.Tensor, State]:
        h, c = state
        gates = (self.gates_x(x) + self.gates_h(h)).float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f + self.forget_bias) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)
