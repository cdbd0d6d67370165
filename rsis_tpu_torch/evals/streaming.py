"""High-resolution streaming inference with the image height sharded over
ranks.

Counterpart of ``rsis_tpu/evals/streaming.py`` (``spatial_mesh``,
``make_streaming_forward``). For native 1024x2048 Cityscapes frames the
conv pyramid's activations dominate memory; instead of the batch, the
HEIGHT is sharded: rank r holds rows r H / N .. (r + 1) H / N - 1 of the
image and of every feature map below it, and returns those rows of the
full-resolution masks (never the whole mask). The outputs equal the
unsharded forward's. XLA derives the halo exchanges from the sharding;
here they are written out, all through one helper,
``parallel.mesh.halo``: each rank's boundary strips travel in one
``all_gather``, and each rank takes its neighbours' rows (zeros, or -inf
for the max pool, beyond the image's edges).

The forward is the unsharded one's own code, run on slabs:

- The encoder runs its forward under ``parallel.mesh.sharded_rows``:
  every convolution and max pool of the trunks reads the halo rows its
  window needs (``models/backbones.Conv2d``, ``MaxPool2d``: the stem's
  7x7/s2 three above and two below, a 3x3/s2 one above, a 3x3/s1 one on
  each side, none for 1x1). Slab edges must align with the strides, so H
  must be divisible by N x 32 (``ValueError`` otherwise; XLA takes any H).
- The decode steps are ``models/rowmajor_decoder.rowmajor_decoder_step``
  (the kernels' path: concat/sum/none with 3x3 gates) and
  ``RSISDecoder.forward`` (mul skips, other kernel sizes), handed a
  ``Slab``, the one place that knows the rows are sharded. Each cell (K1,
  or ``ConvLSTMCell``: K8 for 3x3 gates) runs on its slab plus p = k // 2
  halo rows a side of its input and h (from the neighbours), with zero
  rows of c and S there, and the halo rows of h and c are cropped: the
  cell's SAME padding then touches only rows that are discarded. The
  align-corners upsamples take the rows of the global interpolation
  matrix for the slab's output rows (plus the halo rows the next cell
  reads) over its input rows plus their halo (``upsample_rows``). The
  S terms' 3x3 convolutions take the skips' halo rows. Each cell's global
  max is a MAX all-reduce of the slab's maxima, so the class and stop
  scores are replicated; the mask head runs K2 on the slab and its halo
  rows with the slab's global row offset (``ops/mask_head.py``,
  ``slab=``), the 5x5 head the plain upsample and conv on the slab.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..models.decoder import RSISDecoder
from ..models.encoder import FeatureExtractor
from ..models.rowmajor_decoder import (CHANNEL_SEPARABLE,
                                       _hoist_cells_rowmajor,
                                       init_carry_rowmajor,
                                       rowmajor_decoder_step)
from ..models.rsis import build_models, compute_dtype
from ..ops.mask_head import mask_head_fused_kernel, mask_head_nchw_kernel
from ..ops.upsample import _interp_matrix, interp_matrix, interp_window
from ..parallel.mesh import Group, create_mesh, halo, sharded_rows
from .forward import _same_key, _weights_key

# encoder strides: the slab of every pyramid level must start on a row
# that every stride above it divides
ROW_ALIGN = 32


def spatial_mesh(num_devices: int = 0, device=None) -> Group:
    """The 1-D group whose ranks hold the image's row slabs: every rank
    of the process group (``parallel.mesh.create_mesh``)."""
    return create_mesh(num_devices, device)


def pad_rows(x: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """x with ``rows`` zero rows before and after along ``dim``."""
    shape = list(x.shape)
    shape[dim] = rows
    z = x.new_zeros(shape)
    return torch.cat([z, x, z], dim=dim)


def _window(n_in: int, n_out: int, group: Group, extra: int):
    """For the align-corners resize of n_in to n_out sharded rows: the
    halo (top, bottom) of input rows every rank's window of output rows
    (its slab and ``extra`` rows a side) needs, the same on every rank."""
    m = _interp_matrix(n_in, n_out)
    h_in, h_out = n_in // group.size, n_out // group.size
    top = bottom = 0
    for r in range(group.size):
        lo, hi = max(r * h_out - extra, 0), min((r + 1) * h_out + extra,
                                                n_out)
        used = np.nonzero(m[lo:hi].any(axis=0))[0]
        top = max(top, r * h_in - int(used[0]))
        bottom = max(bottom, int(used[-1]) + 1 - (r + 1) * h_in)
    return top, bottom


def upsample_rows(x: torch.Tensor, n_in: int, n_out: int, out_w: int,
                  group: Group, extra: int = 0, rowmajor: bool = False,
                  pad_cols: bool = False) -> torch.Tensor:
    """Rows A - extra .. A + h + extra - 1 (A = this rank's first row, h =
    n_out / ranks; zero outside the image) of the align-corners resize of
    an H-sharded x (NCHW, or (B, H, C, W) with ``rowmajor``) of an image
    of n_in rows to n_out rows and out_w columns (pad_cols: and a zero
    column on each side). The products run in fp32 from matrices rounded
    to x's dtype, as the unsharded resize's: NCHW cast once at the end,
    row-major after each product."""
    dim = 1 if rowmajor else 2
    top, bottom = _window(n_in, n_out, group, extra)
    xe = halo(x, group, top, bottom, dim)
    h_in, h_out = x.shape[dim], n_out // group.size
    dtype = x.dtype
    rm = interp_window(n_in, n_out, group.rank * h_out - extra,
                       h_out + 2 * extra, group.rank * h_in - top,
                       h_in + top + bottom, dtype, x.device)
    cm = interp_matrix(x.shape[-1], out_w, dtype, x.device, pad=pad_cols)
    if not rowmajor:
        return torch.matmul(torch.matmul(rm, xe.float()), cm.t()).to(dtype)
    b, he, c, w = xe.shape
    y = torch.matmul(rm, xe.reshape(b, he, c * w).float()).to(dtype)
    return torch.matmul(y.reshape(b, -1, c, w).float(), cm.t()).to(dtype)


class Slab:
    """What the shared decode steps do differently on this rank's rows of
    an H-sharded image (``rowmajor_decoder_step(slab=)``,
    ``RSISDecoder.forward(slab=)``); every height they are given is the
    slab's, every image height the slab's times the ranks."""

    def __init__(self, group: Group):
        self.group = group

    def _rows(self, x: torch.Tensor, dim: int) -> Tuple[int, int]:
        """(first global row, image rows) of the slab x."""
        return self.group.rank * x.shape[dim], x.shape[dim] * self.group.size

    def conv(self, skip: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """3x3 SAME convolution of an NCHW slab (the S terms)."""
        return F.conv2d(halo(skip, self.group, 1, 1, dim=2), weight,
                        padding=(0, 1))

    def upsample(self, x: torch.Tensor, out_h: int, out_w: int,
                 extra: int = 0) -> torch.Tensor:
        """The slab's rows (and ``extra`` a side) of the align-corners
        resize of an NCHW image to ``out_h`` slab rows."""
        n = self.group.size
        return upsample_rows(x, x.shape[2] * n, out_h * n, out_w, self.group,
                             extra=extra)

    def upsample_rowmajor(self, h: torch.Tensor, out_h: int, out_w: int,
                          pad: bool = True) -> torch.Tensor:
        """The next cell's x_pad: the (B, H, C, W) resize on the slab and
        its halo row a side, with the cell's zero ring."""
        n = self.group.size
        return pad_rows(upsample_rows(
            h, h.shape[1] * n, out_h * n, out_w, self.group, extra=1,
            rowmajor=True, pad_cols=pad), 1, dim=1)

    def cell_rowmajor(self, fn, h_prev, x_pad, c_prev, s_term, wt, *,
                      cx: int, ch: int):
        """K1 on the slab and a halo row a side (s_term carries zero rows
        there, ``pad_rows``); h and c cropped to the slab."""
        h, c = fn(halo(h_prev, self.group, 1, 1, dim=1), x_pad,
                  pad_rows(c_prev, 1, dim=1), s_term, wt, cx=cx, ch=ch)
        return h[:, 1:-1].contiguous(), c[:, 1:-1].contiguous()

    def cell(self, cell: nn.Module, x: torch.Tensor, state):
        """``ConvLSTMCell`` (NCHW) on the slab and p = k // 2 halo rows a
        side; returns (h, (h, c)) cropped to the slab."""
        p = cell.Gates.padding[0]
        h_prev, c_prev = state
        h, (_, c) = cell(halo(x, self.group, p, p, dim=2),
                         (halo(h_prev, self.group, p, p, dim=2),
                          pad_rows(c_prev, p, dim=2)))
        h = h[:, :, p:-p].contiguous()
        return h, (h, c[:, :, p:-p].contiguous())

    def max(self, feats: torch.Tensor) -> torch.Tensor:
        """The side features' maxima over the whole image."""
        return self.group.all_reduce_(feats.contiguous(), "max")

    def head(self, conv_out: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        """The mask logits of the slab's rows of the 2x-upsampled image
        (NCHW h): K2 for a 3x3 head, else the upsample and conv."""
        row0, full_h = self._rows(h, 2)
        if conv_out.kernel_size == (3, 3):
            return mask_head_nchw_kernel(
                halo(h, self.group, 1, 1, dim=2).contiguous(),
                conv_out.weight, conv_out.bias, slab=(row0, full_h))
        q = conv_out.padding[0]
        up = self.upsample(h, 2 * h.shape[2], 2 * h.shape[3], extra=q)
        return F.conv2d(up, conv_out.weight.to(up.dtype),
                        conv_out.bias.to(up.dtype),
                        padding=(0, conv_out.padding[1]))

    def head_rowmajor(self, conv_out: nn.Conv2d, h: torch.Tensor
                      ) -> torch.Tensor:
        """K2 on the slab ((B, H, C, W) h) and a halo row a side."""
        return mask_head_fused_kernel(
            halo(h, self.group, 1, 1, dim=1).contiguous(), conv_out.weight,
            conv_out.bias, slab=self._rows(h, 1))


def _decode_rowmajor(decoder: RSISDecoder, skips, T: int, skip_mode: str,
                     dtype, slab: Slab):
    """The kernels' decode (K1 cells, K2 head) of H-sharded skips."""
    cells = _hoist_cells_rowmajor(decoder, skips, skip_mode, dtype,
                                  slab.conv)
    for cell in cells:
        cell["s"] = pad_rows(cell["s"], 1, dim=1)
    carry = init_carry_rowmajor(skips, decoder.hidden_size, dtype)
    masks, clss, stops = [], [], []
    for _ in range(T):
        (h, cls, stop), carry = rowmajor_decoder_step(decoder, cells, carry,
                                                      slab=slab)
        masks.append(slab.head_rowmajor(decoder.conv_out, h)[..., 0])
        clss.append(cls)
        stops.append(stop)
    return (torch.stack(masks, 1), torch.stack(clss, 1),
            torch.stack(stops, 1))


def _decode_plain(decoder: RSISDecoder, skips, T: int, slab: Slab):
    """The plain decode (``RSISDecoder``: K8 cells for 3x3 gates, K2 for a
    3x3 head) of H-sharded NCHW skips."""
    carry = None
    masks, clss, stops = [], [], []
    for _ in range(T):
        (mask, cls, stop), carry = decoder(skips, carry, slab=slab)
        masks.append(mask[:, 0])
        clss.append(cls)
        stops.append(stop)
    return (torch.stack(masks, 1), torch.stack(clss, 1),
            torch.stack(stops, 1))


@torch.inference_mode()
def streaming_forward(cfg: Config, encoder: FeatureExtractor,
                      decoder: RSISDecoder, x: torch.Tensor, group: Group,
                      T: int | None = None):
    """``models.rsis.forward`` on this rank's slab x (B, 3, H / N, W) of
    an image of H rows: (sigmoid masks (B, T, H / N, W) of this
    rank's rows, class_probs (B, T, K) and sigmoid stops (B, T, 1), both
    replicated)."""
    T = T if T is not None else cfg.maxseqlen
    dtype = compute_dtype(cfg)
    enc_dtype = next(encoder.parameters()).dtype
    with sharded_rows(group):
        skips = tuple(s.to(dtype) for s in encoder(x.to(enc_dtype)))
    slab = Slab(group)
    if cfg.skip_mode in CHANNEL_SEPARABLE and cfg.kernel_size == 3:
        masks, clss, stops = _decode_rowmajor(decoder, skips, T,
                                              cfg.skip_mode, dtype, slab)
    else:
        masks, clss, stops = _decode_plain(decoder, skips, T, slab)
    if tuple(masks.shape[-2:]) != tuple(x.shape[2:]):
        masks = slab.upsample(masks, x.shape[2], x.shape[3])
    return torch.sigmoid(masks), clss, torch.sigmoid(stops)


def check_height(h: int, group: Group) -> int:
    """The slab height of an image of h rows over the group's ranks;
    raises unless every pyramid level's slab starts on a stride."""
    if h % (group.size * ROW_ALIGN):
        raise ValueError(f"streaming needs H divisible by {group.size} "
                         f"ranks x {ROW_ALIGN}; got H={h}")
    return h // group.size


def make_streaming_forward(cfg: Config, group: Group, T: int | None = None):
    """Returns run((encoder, decoder), x_nhwc) -> (masks, class_probs,
    stops), the forward with the height sharded over ``group``'s ranks
    (``spatial_mesh``; its device is this rank's).

    x_nhwc is the whole (B, H, W, 3) normalised image batch, the same on
    every rank (host or device; only this rank's rows are copied to its
    device); masks (B, T, H / N, W) are this rank's rows of the full
    masks, class_probs (B, T, K) and stops (B, T, 1) are the same on
    every rank. The weights are state_dicts or modules, copied in as
    ``evals/forward.make_forward`` copies them; the encoder runs in the
    compute dtype. H must be divisible by N x 32 (``ValueError``)."""
    T = T or cfg.maxseqlen
    device = resolve_device(group.device, "make_streaming_forward")
    encoder, decoder = build_models(cfg)
    encoder = encoder.to(device=device, dtype=compute_dtype(cfg))
    decoder = decoder.to(device=device)
    loaded = [None, None]

    def run(weights: Tuple, x_nhwc) -> Sequence[torch.Tensor]:
        for i, (module, w) in enumerate(zip((encoder, decoder), weights)):
            key = _weights_key(w)
            if not _same_key(loaded[i], key):
                module.load_state_dict(
                    w.state_dict() if isinstance(w, nn.Module) else w)
                loaded[i] = key
        h = check_height(x_nhwc.shape[1], group)
        rows = torch.as_tensor(x_nhwc[:, group.rank * h:(group.rank + 1) * h])
        x = rows.to(device).permute(0, 3, 1, 2).contiguous()
        return streaming_forward(cfg, encoder, decoder, x, group, T)

    return run
