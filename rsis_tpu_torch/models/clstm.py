"""Convolutional LSTM cell, NCHW.

Counterpart of ``rsis_tpu/models/clstm.py`` (``lstm_state_update``,
``ConvLSTMCell``): one convolution over concat(input, h_prev) gives 4C
gate channels in the order input, forget, output, cell.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def lstm_state_update(gates: torch.Tensor, c_prev: torch.Tensor):
    """Pointwise ConvLSTM update; gates (B, 4C, ...) in i, f, o, g order."""
    i, f, o, g = torch.chunk(gates, 4, dim=1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


class ConvLSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        self.hidden = hidden
        self.Gates = nn.Conv2d(input_size + hidden, 4 * hidden, kernel_size,
                               padding=(kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor, state=None):
        """One step. x: (B, Cin, H, W); state: (h, c), each
        (B, hidden, H, W), or None to start from zeros on x's device."""
        if state is None:
            z = x.new_zeros((x.shape[0], self.hidden) + tuple(x.shape[2:]))
            state = (z, z)
        h_prev, c_prev = state
        # parameters stay fp32 and are cast to the compute dtype at use
        gates = F.conv2d(torch.cat([x, h_prev.to(x.dtype)], dim=1),
                         self.Gates.weight.to(x.dtype),
                         self.Gates.bias.to(x.dtype),
                         padding=self.Gates.padding)
        h, c = lstm_state_update(gates, c_prev.to(gates.dtype))
        return h, (h, c)
