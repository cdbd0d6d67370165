"""RSIS recurrent decoder, one step: five ConvLSTM cells and the heads.

Counterpart of ``rsis_tpu/models/decoder.py`` (``decoder_widths``,
``init_carry``, ``RSISDecoder``). Each cell's hidden state is upsampled
(align_corners) to the next skip scale and fused with that skip
(concat/sum/mul/none); the finest state is upsampled 2x and projected to
one channel of mask logits (with no gradient recorded and a 3x3 head, one
launch of the mask head kernel K2 on the state itself,
``ops/mask_head.mask_head_nchw_kernel``, which never materialises the
upsample); the global max of every cell's state feeds
``fc_class`` and ``fc_stop``. In training mode (``module.train()``) the
three dropouts of the reference act: ``dropout`` zeroes whole channels of
each cell's hidden state (one draw per image and channel, kept over H and
W as flax's ``broadcast_dims=(1, 2)``) before its global max and its
upsample, ``dropout_cls`` and ``dropout_stop`` act on the concatenated
side features before each head; in eval mode all three are identity.
Their random numbers come from the ``generator`` passed to ``forward``,
never from torch's global state. This is the plain decode: the only path
for skip_mode "mul" and for a training step that needs dropout; the other
cases go through ``models/rowmajor_decoder.py`` and its kernels.
Parameters stay fp32 and are cast to the input's dtype at use, as the flax
modules do.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mask_head import mask_head_nchw_kernel
from ..ops.upsample import upsample_bilinear_align_corners
from .clstm import ConvLSTMCell

SKIP_MODES = ("concat", "sum", "mul", "none")


def decoder_widths(hidden_size: int) -> Tuple[int, ...]:
    """ConvLSTM hidden widths per scale, halving as resolution doubles."""
    h = hidden_size
    return (h, h // 2, h // 4, h // 8, h // 16)


def skip_widths(hidden_size: int) -> Tuple[int, ...]:
    """Encoder skip widths (x5..x1) for a hidden size."""
    h = hidden_size
    return (h, h, h // 2, h // 4, h // 8)


def init_carry(skips: Sequence[torch.Tensor], hidden_size: int):
    """Zero (h, c) pyramid (NCHW) on the skips' device and dtype."""
    return tuple((s.new_zeros((s.shape[0], w) + tuple(s.shape[2:])),) * 2
                 for s, w in zip(skips, decoder_widths(hidden_size)))


def _linear(x: torch.Tensor, fc: nn.Linear) -> torch.Tensor:
    return F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            keep_shape, rows=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each entry of a ``keep_shape`` draw
    (broadcast over x) with probability 1 - rate and scale the kept ones
    by 1 / (1 - rate). rows = (offset, global batch): x holds those rows
    of a global batch; the draw is made at the global shape and these
    rows kept."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if rows is None:
        draw = torch.rand(keep_shape, generator=generator,
                          device=generator.device)
    else:
        off, total = rows
        draw = torch.rand((total,) + tuple(keep_shape[1:]),
                          generator=generator,
                          device=generator.device)[off:off + keep_shape[0]]
    keep = (draw < keep_prob).to(x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class RSISDecoder(nn.Module):
    def __init__(self, hidden_size: int = 128, num_classes: int = 21,
                 kernel_size: int = 3, skip_mode: str = "concat",
                 dropout: float = 0.0, dropout_cls: float = 0.0,
                 dropout_stop: float = 0.0):
        super().__init__()
        if skip_mode not in SKIP_MODES:
            raise ValueError(f"unsupported skip_mode {skip_mode!r}")
        self.hidden_size = hidden_size
        self.skip_mode = skip_mode
        self.dropout = dropout
        self.dropout_cls = dropout_cls
        self.dropout_stop = dropout_stop
        widths = decoder_widths(hidden_size)
        skips = skip_widths(hidden_size)
        cells = []
        for i, width in enumerate(widths):
            if i == 0:
                cin = skips[0]
            elif skip_mode == "concat":
                cin = widths[i - 1] + skips[i]
            else:
                cin = widths[i - 1]
            cells.append(ConvLSTMCell(cin, width, kernel_size))
        self.clstm_list = nn.ModuleList(cells)
        self.conv_out = nn.Conv2d(widths[-1], 1, kernel_size,
                                  padding=(kernel_size - 1) // 2)
        self.fc_class = nn.Linear(sum(widths), num_classes)
        self.fc_stop = nn.Linear(sum(widths), 1)

    def needs_generator(self) -> bool:
        """Whether ``forward`` draws random numbers (training mode with a
        dropout rate above 0)."""
        return self.training and (self.dropout > 0 or self.dropout_cls > 0
                                  or self.dropout_stop > 0)

    def forward(self, skips: Sequence[torch.Tensor], carry=None,
                generator: torch.Generator | None = None,
                plain: bool = False, rows=None, slab=None):
        """One decode step.

        skips: 5 skip features (x5..x1, NCHW); carry: the state pyramid
        of the previous step, or None for zeros; generator: the source of
        the dropouts' random numbers, needed when ``needs_generator()``;
        rows: (offset, global batch) of a rank's rows of a data-parallel
        batch, whose dropouts are drawn at the global shape;
        plain: the cells take K8's plain version (``ConvLSTMCell``) and
        the head the upsample and ``F.conv2d`` in place of K2;
        slab: the ``evals/streaming.Slab`` of an H-sharded forward (skips
        and carry are this rank's rows): the cells, the upsamples and the
        head read the neighbours' rows through it, and the side features
        are maxed over its ranks.
        Returns ((mask_logits (B, 1, 2H1, 2W1), class_probs (B, K),
        stop_logits (B, 1)), new_carry)."""
        if self.needs_generator() and generator is None:
            raise ValueError("decoder dropout in training mode needs a "
                             "torch.Generator")
        train = self.training
        if carry is None:
            carry = init_carry(skips, self.hidden_size)
        clstm_in = skips[0]
        new_carry, side_feats = [], []
        n = len(self.clstm_list)
        for i, cell in enumerate(self.clstm_list):
            if slab is None:
                hidden, state = cell(clstm_in, carry[i], plain=plain)
            else:
                hidden, state = slab.cell(cell, clstm_in, carry[i])
            new_carry.append(state)
            if train and self.dropout > 0:
                hidden = dropout(hidden, self.dropout, generator,
                                 hidden.shape[:2] + (1, 1), rows)
            side_feats.append(hidden.amax(dim=(2, 3)))
            if i + 1 < n:
                nxt = skips[i + 1]
                up = (upsample_bilinear_align_corners if slab is None
                      else slab.upsample)(hidden, nxt.shape[2], nxt.shape[3])
                if self.skip_mode == "concat":
                    clstm_in = torch.cat([up, nxt], dim=1)
                elif self.skip_mode == "sum":
                    clstm_in = up + nxt
                elif self.skip_mode == "mul":
                    clstm_in = up * nxt
                else:
                    clstm_in = up
        if slab is not None:
            mask_logits = slab.head(self.conv_out, hidden)
        elif (not plain and self.conv_out.kernel_size == (3, 3)
                and not torch.is_grad_enabled()):
            # K2 on the hidden state itself: the upsample never exists
            mask_logits = mask_head_nchw_kernel(hidden.contiguous(),
                                                self.conv_out.weight,
                                                self.conv_out.bias)
        else:
            up = upsample_bilinear_align_corners(
                hidden, hidden.shape[2] * 2, hidden.shape[3] * 2)
            mask_logits = F.conv2d(up, self.conv_out.weight.to(up.dtype),
                                   self.conv_out.bias.to(up.dtype),
                                   padding=self.conv_out.padding)
        feats = torch.cat(side_feats, dim=-1)
        if slab is not None:
            feats = slab.max(feats)
        cls_in, stop_in = feats, feats
        if train and self.dropout_cls > 0:
            cls_in = dropout(feats, self.dropout_cls, generator,
                             feats.shape, rows)
        if train and self.dropout_stop > 0:
            stop_in = dropout(feats, self.dropout_stop, generator,
                              feats.shape, rows)
        class_probs = torch.softmax(_linear(cls_in, self.fc_class), dim=-1)
        stop_logits = _linear(stop_in, self.fc_stop)
        return (mask_logits, class_probs, stop_logits), tuple(new_carry)
