"""Kernel decode loop in the (B, H, C, W) layout.

Counterpart of ``rsis_tpu/models/rowmajor_decoder.py``
(``_hoist_cells_rowmajor``, ``rowmajor_decoder_step``,
``decode_sequence_rowmajor``; its ``_upsample_rowmajor`` is
``ops/upsample.py``'s ``upsample_rowmajor_ref``). The math per
step is the plain decoder's (``models/decoder.py``), restructured around
the linearity of the gate conv:

  - the skip features are constant across the T steps, so
    conv(concat(up, skip, h)) = conv_x(up) + conv_s(skip) + conv_h(h), and
    S = conv_s(skip) + bias is computed once per forward (the "S terms");
  - each cell step is one ``fused_cell_rowmajor`` launch (K1) on the
    upsampled previous cell's state, written with its zero halo ring by
    one launch of ``csrc/upsample.cu`` (the ring is the zero first and last
    row of the plain version's interpolation matrices);
  - the mask head is one ``mask_head_fused_kernel`` launch (K2) per step.

The S terms, h and c are stored in the compute dtype between cells and
steps; the upsample rounds its row pass and its column pass each to that
dtype, as the reference's two fp32 products and casts do (bit for bit in
bf16). Under autograd the S terms' cotangent is summed over the T steps
in their dtype, as the reference sums it.

The same loop trains (the counterpart of ``rowmajor_decoder_step``'s
differentiable path): the cells run through ``FusedCellFunction``, the
head through ``MaskHeadFunction`` and the upsample through
``UpsampleFunction``. The cells' and the head's backwards are kernels
too; the upsample's backward is the pullback of its plain version
(``upsample_rowmajor_ref``, two fp32 products) through autograd, and the
S-term hoist and the global max stay plain autograd (``amax`` splits tied
cotangents evenly, as ``jnp.max`` does). plain=True runs the kernels'
plain versions under autograd instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.fused_cell import fused_cell_rowmajor_ref, pack_cell_weights
from ..ops.fused_cell_vjp import FusedCellFunction
from ..ops.mask_head import MaskHeadFunction, mask_head_ref
from ..ops.upsample import UpsampleFunction, upsample_rowmajor_ref
from ..utils.profiling import span
from .decoder import RSISDecoder, decoder_widths

CHANNEL_SEPARABLE = ("concat", "sum", "none")


def _conv_same(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, weight, padding=1)


def _hoist_cells_rowmajor(decoder: RSISDecoder,
                          skips: Sequence[torch.Tensor], skip_mode: str,
                          dtype: torch.dtype, conv=_conv_same):
    """Per cell: packed weight, S term (B, H, 4C, W) in ``dtype``, cx and
    ch.

    skips are NCHW. The gate weight (4C, Cin, 3, 3) splits along Cin into
    the up-input (kx), skip (ks) and hidden (kh) parts. conv(skip, weight)
    is the 3x3 SAME convolution of a skip (the streaming forward's takes
    the halo rows of an H-sharded skip)."""
    widths = decoder_widths(decoder.hidden_size)
    cells = []
    for i, ch in enumerate(widths):
        gates = decoder.clstm_list[i].Gates
        kernel, bias = gates.weight, gates.bias
        skip = skips[i].to(dtype)
        b_ = bias.to(dtype)[None, :, None, None]
        if i == 0:
            cs = skip.shape[1]
            s_term = conv(skip, kernel[:, :cs].to(dtype)) + b_
            step_kernel, cx = kernel[:, cs:], 0
        else:
            cp = widths[i - 1]
            kx = kernel[:, :cp]
            if skip_mode == "concat":
                cs = skip.shape[1]
                s_term = conv(skip, kernel[:, cp:cp + cs].to(dtype)) + b_
                kh = kernel[:, cp + cs:]
            elif skip_mode == "sum":
                s_term = conv(skip, kx.to(dtype)) + b_
                kh = kernel[:, cp:]
            elif skip_mode == "none":
                bsz, _, hh, ww = skip.shape
                s_term = b_.expand(bsz, 4 * ch, hh, ww)
                kh = kernel[:, cp:]
            else:
                raise ValueError(
                    f"skip_mode {skip_mode!r} is not channel-separable")
            step_kernel, cx = torch.cat([kx, kh], dim=1), cp
        cells.append({
            "wt": pack_cell_weights(step_kernel, cx, ch, dtype=dtype),
            "s": s_term.permute(0, 2, 1, 3).contiguous(), "cx": cx,
            "ch": ch})
    return cells


def init_carry_rowmajor(skips: Sequence[torch.Tensor], hidden_size: int,
                        dtype: torch.dtype):
    """Zero (h, c) pyramid, (B, H, C, W) per cell, on the skips' device."""
    return tuple(
        (torch.zeros((s.shape[0], s.shape[2], ch, s.shape[3]), dtype=dtype,
                     device=s.device),) * 2
        for s, ch in zip(skips, decoder_widths(hidden_size)))


def _fused_cell(*args, cx: int, ch: int):
    return FusedCellFunction.apply(*args, cx, ch)


def rowmajor_decoder_step(decoder: RSISDecoder, cells, carry,
                          plain: bool = False, slab=None):
    """One decode step; carry is a tuple of (h, c) in (B, H, C, W).

    Returns ((finest h, class_probs, stop_logits), new_carry): the caller
    owns the mask head. plain=True runs the kernels' plain versions.
    slab: the ``evals/streaming.Slab`` of an H-sharded forward (cells and
    carry hold this rank's rows): each cell runs on the slab and its
    neighbours' rows, the upsample reads the slab's rows of the global
    interpolation, and the side features are maxed over its ranks."""
    cell_fn = fused_cell_rowmajor_ref if plain else _fused_cell
    if slab is not None:
        upsample = slab.upsample_rowmajor
    else:
        upsample = (upsample_rowmajor_ref if plain
                    else UpsampleFunction.apply)
    side_feats, new_carry = [], []
    h = None
    for i, cell in enumerate(cells):
        h_prev, c_prev = carry[i]
        x_pad = None
        if i > 0:
            with span("rsis.decode.upsample"):
                x_pad = upsample(h, h_prev.shape[1], h_prev.shape[3], True)
        args = (h_prev, x_pad, c_prev, cell["s"], cell["wt"])
        if slab is None:
            h, c = cell_fn(*args, cx=cell["cx"], ch=cell["ch"])
        else:
            h, c = slab.cell_rowmajor(cell_fn, *args, cx=cell["cx"],
                                      ch=cell["ch"])
        new_carry.append((h, c))
        side_feats.append(h.amax(dim=(1, 3)))
    feats = torch.cat(side_feats, dim=-1)
    if slab is not None:
        feats = slab.max(feats)
    class_probs, stop_logits = heads(decoder, feats)
    return (h, class_probs, stop_logits), tuple(new_carry)


def heads(decoder: RSISDecoder, feats: torch.Tensor):
    """(class_probs, stop_logits) of the side features (B, sum C), in
    their dtype."""
    dt = feats.dtype
    fc_c, fc_s = decoder.fc_class, decoder.fc_stop
    class_probs = torch.softmax(
        F.linear(feats, fc_c.weight.to(dt), fc_c.bias.to(dt)), dim=-1)
    stop_logits = F.linear(feats, fc_s.weight.to(dt), fc_s.bias.to(dt))
    return class_probs, stop_logits


def decode_sequence_rowmajor(decoder: RSISDecoder,
                             skips: Sequence[torch.Tensor], T: int,
                             skip_mode: str = "concat",
                             dtype: torch.dtype = torch.bfloat16,
                             plain: bool = False):
    """T decode steps through the kernels (plain=True: their plain
    versions, on any device).

    skips: 5 NCHW skip features (x5..x1). Returns masks (B, T, 2H, 2W)
    logits, class_probs (B, T, K) and stop_logits (B, T, 1)."""
    if skip_mode not in CHANNEL_SEPARABLE:
        raise ValueError(f"skip_mode {skip_mode!r} is not channel-separable")
    head_fn = mask_head_ref if plain else MaskHeadFunction.apply
    with span("rsis.decode"):
        with span("rsis.hoist"):
            cells = _hoist_cells_rowmajor(decoder, skips, skip_mode, dtype)
        carry = init_carry_rowmajor(skips, decoder.hidden_size, dtype)
        head_w = decoder.conv_out.weight
        head_b = decoder.conv_out.bias
        masks, clss, stops = [], [], []
        for _ in range(T):
            (h_fine, cls, stop), carry = rowmajor_decoder_step(
                decoder, cells, carry, plain=plain)
            masks.append(head_fn(h_fine, head_w, head_b)[..., 0])
            clss.append(cls)
            stops.append(stop)
        return (torch.stack(masks, dim=1), torch.stack(clss, dim=1),
                torch.stack(stops, dim=1))
