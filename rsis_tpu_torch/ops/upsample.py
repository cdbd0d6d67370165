"""Bilinear upsampling with align_corners=True.

Counterpart of ``rsis_tpu/ops/upsample.py`` (``_interp_matrix``,
``upsample_bilinear_align_corners``) and of the inter-cell upsample of
``rsis_tpu/models/rowmajor_decoder.py`` (``_upsample_rowmajor``). The
separable interpolation is an (H_out, H_in) row matrix and a (W_out,
W_in) column matrix, built in numpy exactly as the reference builds them,
so both packages interpolate with the same weights.

Layout differs from the reference: the spatial dims of
``upsample_bilinear_align_corners`` are the LAST two, (..., H, W), the
NCHW convention of the port's model modules.

The decode's inter-cell upsample, (B, H, C, W) -> (B, out_h (+2), C,
out_w (+2)), has two versions: ``upsample_rowmajor_ref``, the plain one
(the two interpolation matrices as fp32 products, as the reference
computes it), and on a CUDA tensor ``upsample_rowmajor_kernel``, the
hand-written kernel ``csrc/upsample.cu``, which applies each output row's
and column's two taps (``interp_taps``) and is bit-identical to the plain
version in bf16. The decode calls ``UpsampleFunction``: the kernel
forward and the plain version's pullback through autograd.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


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


@functools.lru_cache(maxsize=128)
def interp_taps(n_in: int, n_out: int, dtype: torch.dtype,
                device: torch.device, pad: bool = False) -> torch.Tensor:
    """The two taps of each row of ``interp_matrix(n_in, n_out, dtype,
    pad=pad)``, the tables of ``csrc/upsample.cu``: an (n_out + 2 pad, 4)
    int32 tensor on ``device`` whose row i is (lo, hi, w_lo, w_hi), the
    weights as float32 bits, with row i of the matrix equal to w_lo at
    column lo plus w_hi at column hi. A row with one nonzero entry has
    lo = hi and w_hi = 0; a ring row (pad) is all zeros. Cached per device
    like ``interp_matrix``; callers must not write to it."""
    m = interp_matrix(n_in, n_out, dtype, torch.device("cpu"), pad).numpy()
    lo_hi = np.zeros((m.shape[0], 2), dtype=np.int32)
    weights = np.zeros((m.shape[0], 2), dtype=np.float32)
    for i, row in enumerate(m):
        cols = np.flatnonzero(row)
        if cols.size > 2:
            raise ValueError(f"row {i} of the ({n_in} -> {n_out}) "
                             f"interpolation has {cols.size} taps")
        if cols.size:
            lo_hi[i] = cols[0], cols[-1]
            weights[i, :cols.size] = row[cols]
    taps = np.concatenate([lo_hi, weights.view(np.int32)], axis=1)
    with torch.inference_mode(False):
        return torch.from_numpy(taps).to(device)


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


def upsample_rowmajor_ref(x: torch.Tensor, out_h: int, out_w: int,
                          pad: bool = False) -> torch.Tensor:
    """Plain version: (B, H, C, W) -> (B, out_h, C, out_w), align-corners
    bilinear.

    pad=True returns the (out_h + 2, out_w + 2) tensor with a zero halo
    ring, the x_pad the cell kernel takes: the pad is a zero first and last
    row of each interpolation matrix. Each product accumulates in fp32 and
    is cast to the input dtype."""
    b, h, c, w = x.shape
    dtype = x.dtype
    rm = interp_matrix(h, out_h, dtype, x.device, pad=pad)
    cm = interp_matrix(w, out_w, dtype, x.device, pad=pad)
    y = torch.matmul(rm, x.reshape(b, h, c * w).float()).to(dtype)
    y = torch.matmul(y.reshape(b, -1, c, w).float(), cm.t()).to(dtype)
    return y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("upsample")
    lib.rsis_upsample.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                  + [ctypes.c_void_p])
    lib.rsis_upsample.restype = ctypes.c_int
    return lib


def upsample_rowmajor_kernel(x: torch.Tensor, out_h: int, out_w: int,
                             pad: bool = False) -> torch.Tensor:
    """``upsample_rowmajor_ref``'s function in one pass.

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16,
    contiguous) launch ``csrc/upsample.cu`` on the taps of
    ``interp_taps`` and count one launch in
    ``upsample_rowmajor_kernel.launches``; in bf16 the output is
    bit-identical to the plain version's, in fp32 within an ulp of it."""
    if x.device.type == "cpu":
        return upsample_rowmajor_ref(x, out_h, out_w, pad)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _ELEM_BYTES:
        raise TypeError(f"upsample kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"upsample kernel needs a contiguous (B, H, C, W) "
                         f"input, got {tuple(x.shape)} with strides "
                         f"{x.stride()}")
    b, h, c, w = x.shape
    ho, wo = out_h + 2 * pad, out_w + 2 * pad
    out = torch.empty((b, ho, c, wo), dtype=x.dtype, device=x.device)
    row_taps = interp_taps(h, out_h, x.dtype, x.device, pad)
    col_taps = interp_taps(w, out_w, x.dtype, x.device, pad)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_upsample(
            x.data_ptr(), row_taps.data_ptr(), col_taps.data_ptr(),
            out.data_ptr(), b, h, c, w, ho, wo, int(pad), x.element_size(),
            stream)
    if err != 0:
        raise RuntimeError(f"upsample kernel launch failed: CUDA error "
                           f"{err}")
    upsample_rowmajor_kernel.launches += 1
    return out


upsample_rowmajor_kernel.launches = 0


class UpsampleFunction(torch.autograd.Function):
    """Differentiable inter-cell upsample: apply(x, out_h, out_w, pad) ->
    ``upsample_rowmajor_kernel(x, out_h, out_w, pad)``.

    The forward is the kernel on CUDA tensors; the backward is the pullback
    of the plain version ``upsample_rowmajor_ref`` through autograd. The
    map is linear, so the pullback needs nothing of the forward but the
    input's shape, dtype and device (the JAX package has no kernel for
    it either)."""

    @staticmethod
    def forward(ctx, x, out_h, out_w, pad):
        ctx.input = (x.shape, x.dtype, x.device)
        ctx.args = (out_h, out_w, pad)
        return upsample_rowmajor_kernel(x, out_h, out_w, pad)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.input
        with torch.enable_grad():
            x = torch.zeros(shape, dtype=dtype, device=device,
                            requires_grad=True)
            out = upsample_rowmajor_ref(x, *ctx.args)
            (dx,) = torch.autograd.grad(out, x, grad)
        return dx, None, None, None
