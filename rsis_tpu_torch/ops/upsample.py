"""Bilinear upsampling with align_corners=True as two matrix products.

Counterpart of ``rsis_tpu/ops/upsample.py`` (``_interp_matrix``,
``upsample_bilinear_align_corners``). The separable interpolation is an
(H_out, H_in) row matrix and a (W_out, W_in) column matrix, built in
numpy exactly as the reference builds them, so both packages interpolate
with the same weights.

Layout differs from the reference: the spatial dims are the LAST two,
(..., H, W), the NCHW convention of the port's model modules.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear interpolation weights, align_corners=True."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        x = i * scale
        lo = int(np.floor(x))
        hi = min(lo + 1, n_in - 1)
        frac = x - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


@functools.lru_cache(maxsize=128)
def interp_matrix(n_in: int, n_out: int, dtype: torch.dtype,
                  device: torch.device, pad: bool = False) -> torch.Tensor:
    """``_interp_matrix`` rounded to ``dtype`` and held in float32 on
    ``device``, for fp32 products. pad=True adds a zero first and last
    row: the product then carries a one-pixel zero border.

    Cached per device, so the decode loop copies no matrix from the host
    (a copy from pageable memory waits for the device) after its first
    step. The cached tensor is shared: callers must not write to it."""
    m = _interp_matrix(n_in, n_out)
    if pad:
        m = np.pad(m, ((1, 1), (0, 0)))
    with torch.inference_mode(False):
        return torch.as_tensor(m, dtype=dtype).float().to(device)


@functools.lru_cache(maxsize=256)
def interp_window(n_in: int, n_out: int, out_lo: int, out_n: int,
                  in_lo: int, in_n: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """Rows out_lo .. out_lo + out_n - 1 of ``_interp_matrix(n_in, n_out)``
    restricted to input rows in_lo .. in_lo + in_n - 1, rounded to
    ``dtype`` and held in float32 on ``device``: the row matrix of a slab
    of an image whose rows are sharded (``evals/streaming.py``). Rows
    outside [0, n_out) are zero (a zero border), and so are input rows
    outside [0, n_in); a kept row with weight outside the window raises.
    The cached tensor is shared: callers must not write to it."""
    m = _interp_matrix(n_in, n_out)
    out = np.zeros((out_n, in_n), dtype=np.float32)
    lo, hi = max(in_lo, 0), min(in_lo + in_n, n_in)
    for i in range(out_n):
        o = out_lo + i
        if not 0 <= o < n_out:
            continue
        used = np.nonzero(m[o])[0]
        if used.size and (used[0] < lo or used[-1] >= hi):
            raise ValueError(f"output row {o} reads input rows "
                             f"{used.tolist()}, outside {lo}..{hi - 1}")
        out[i, lo - in_lo:hi - in_lo] = m[o, lo:hi]
    with torch.inference_mode(False):
        return torch.as_tensor(out, dtype=dtype).float().to(device)


def upsample_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                    out_w: int) -> torch.Tensor:
    """Resize (..., H, W) to (..., out_h, out_w), align_corners=True.

    Both products run in float32 and the result is cast back once, as the
    reference does (fp32 accumulation of the compute-dtype operands:
    bf16 inputs and bf16-rounded interpolation weights multiply exactly
    in fp32)."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    dtype = x.dtype
    rm = interp_matrix(h, out_h, dtype, x.device)
    cm = interp_matrix(w, out_w, dtype, x.device)
    y = torch.matmul(rm, x.float())
    y = torch.matmul(y, cm.t())
    return y.to(dtype)
