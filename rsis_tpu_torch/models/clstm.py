"""Convolutional LSTM cell, NCHW.

Counterpart of ``rsis_tpu/models/clstm.py`` (``lstm_state_update``,
``ConvLSTMCell``): one convolution over concat(input, h_prev) gives 4C
gate channels in the order input, forget, output, cell. A 3x3 cell with
no gradient being recorded (inference) runs through ``ops/clstm_step.py``:
one launch of the ConvLSTM step kernel K8 on a CUDA tensor, its plain
version on a CPU tensor or when the caller asks for the plain version
(the oracle K8 is held against). Under autograd, and for other kernel
sizes, the convolution and the update run in PyTorch in the input's
dtype, as the flax cell computes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.clstm_step import clstm_step


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

    def forward(self, x: torch.Tensor, state=None, plain: bool = False):
        """One step. x: (B, Cin, H, W); state: (h, c), each
        (B, hidden, H, W), or None to start from zeros on x's device.
        plain=True takes K8's plain version on the card."""
        if state is None:
            z = x.new_zeros((x.shape[0], self.hidden) + tuple(x.shape[2:]))
            state = (z, z)
        h_prev, c_prev = state
        # parameters stay fp32 and are cast to the compute dtype at use
        if self.Gates.kernel_size == (3, 3) and not torch.is_grad_enabled():
            h, c = clstm_step(x.contiguous(),
                              h_prev.to(x.dtype).contiguous(),
                              c_prev.to(x.dtype).contiguous(),
                              self.Gates.weight, self.Gates.bias,
                              plain=plain)
            return h, (h, c)
        gates = F.conv2d(torch.cat([x, h_prev.to(x.dtype)], dim=1),
                         self.Gates.weight.to(x.dtype),
                         self.Gates.bias.to(x.dtype),
                         padding=self.Gates.padding)
        h, c = lstm_state_update(gates, c_prev.to(gates.dtype))
        return h, (h, c)
