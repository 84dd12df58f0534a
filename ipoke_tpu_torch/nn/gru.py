"""Convolutional GRU (counterpart of ``ipoke_tpu/nn/gru.py``), NHWC."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .blocks import Conv


class ConvGRUCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        cin = input_size + hidden_size
        self.update_gate = Conv(cin, hidden_size, kernel_size, 1, pad)
        self.reset_gate = Conv(cin, hidden_size, kernel_size, 1, pad)
        self.out_gate = Conv(cin, hidden_size, kernel_size, 1, pad)

    def forward(self, x, h):
        """x: (B, H, W, Cin), h: (B, H, W, hidden) -> new hidden."""
        xh = torch.cat([x, h], dim=-1)
        update = torch.sigmoid(self.update_gate(xh))
        reset = torch.sigmoid(self.reset_gate(xh))
        out = torch.tanh(self.out_gate(torch.cat([x, h * reset], dim=-1)))
        return h * (1.0 - update) + out * update


class ConvGRU(nn.Module):
    """``n_layers`` stacked cells; the hidden state is a tuple per layer."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 kernel_size: int = 3):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"cell_{i}", ConvGRUCell(
                input_size if i == 0 else hidden_size, hidden_size, kernel_size))

    def forward(self, x, hidden: Tuple) -> Tuple:
        new_hidden = []
        inp = x
        for i in range(self.n_layers):
            inp = getattr(self, f"cell_{i}")(inp, hidden[i])
            new_hidden.append(inp)
        return tuple(new_hidden)
