"""One ConvLSTM step on NCHW tensors: 3x3 gate conv, bias, LSTM update.

Counterpart of ``rsis_tpu/ops/pallas_clstm.py::fused_convlstm_step`` (the
Pallas ``_cell_kernel``). One step is

  gates = conv3x3_same(concat(x, h_prev), weight) + bias
  c = sig(f) * c_prev + sig(i) * tanh(g);   h = sig(o) * tanh(c)

with gate order i, f, o, g, the gate sum, the bias and the update in fp32,
and h, c stored in x's dtype. On a CUDA tensor ``clstm_step`` launches the
hand-written kernel ``csrc/clstm_step.cu`` (the staged loop of the decode
cell, cut by ``fused_cell.cell_plan(..., kind="step")``); on a CPU tensor
it runs ``clstm_step_ref``, the plain PyTorch version of the same
arithmetic. ``fused_convlstm_step`` keeps the JAX function's NHWC/HWIO
signature.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .fused_cell import cell_plan, plan_args, workspace

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def clstm_step_ref(x: torch.Tensor, h_prev: torch.Tensor,
                   c_prev: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor):
    """Plain PyTorch version of the kernel: the weight rounded to x's
    dtype, the gate convolution of the upcast inputs and the update in
    fp32, h and c rounded once to x's dtype. x (B, Cx, H, W), h_prev and
    c_prev (B, C, H, W), weight (4C, Cx+C, 3, 3), bias (4C,)."""
    dtype = x.dtype
    gates = F.conv2d(torch.cat([x.float(), h_prev.float()], dim=1),
                     weight.to(dtype).float(), bias.float(), padding=1)
    i, f, o, g = torch.chunk(gates, 4, dim=1)
    c = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.to(dtype), c.to(dtype)


def ohwi_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The FMA loop's weight: the OIHW (4C, Cx+C, 3, 3) gate weight as a
    contiguous OHWI (4C, 3, 3, Cx+C) tensor in ``dtype``, written by one
    copy that also casts."""
    out = torch.empty(weight.shape[:1] + weight.shape[2:] + weight.shape[1:2],
                      dtype=dtype, device=weight.device)
    return out.copy_(weight.permute(0, 2, 3, 1))


def packed_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The staged loop's weight: the OIHW (4C, Cx+C, 3, 3) gate weight as
    ``fused_cell.pack_cell_weights`` lays it out, (4C, 9(Cx+C)) with the 9
    x taps first (tap-major, channel-minor), then the 9 h taps, in
    ``dtype``, written by one copy a part that also casts."""
    g4, cin = weight.shape[:2]
    cx = cin - g4 // 4
    out = torch.empty(g4, 9 * cin, dtype=dtype, device=weight.device)
    for lo, hi in ((0, cx), (cx, cin)):
        if hi > lo:
            out[:, 9 * lo:9 * hi].view(g4, 3, 3, hi - lo).copy_(
                weight[:, lo:hi].permute(0, 2, 3, 1))
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("clstm_step")
    lib.rsis_clstm_step.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 18
        + [ctypes.c_void_p])
    lib.rsis_clstm_step.restype = ctypes.c_int
    return lib


def _check(x, h_prev, c_prev, weight, bias):
    b, cx, h, w = x.shape
    ch = h_prev.shape[1]
    if tuple(h_prev.shape) != (b, ch, h, w) or tuple(c_prev.shape) != (
            b, ch, h, w):
        raise ValueError(f"h_prev {tuple(h_prev.shape)} / c_prev "
                         f"{tuple(c_prev.shape)} are not (B, C, H, W) of x "
                         f"{tuple(x.shape)}")
    if tuple(weight.shape) != (4 * ch, cx + ch, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not "
                         f"{(4 * ch, cx + ch, 3, 3)}")
    if tuple(bias.shape) != (4 * ch,):
        raise ValueError(f"bias {tuple(bias.shape)} is not {(4 * ch,)}")
    tensors = (x, h_prev, c_prev, weight, bias)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if any(t.dtype != x.dtype for t in (h_prev, c_prev)):
        raise ValueError("x, h_prev and c_prev must share one dtype")


def clstm_step(x: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, plain: bool = False):
    """One ConvLSTM step, NCHW.

    Args:
      x: (B, Cx, H, W) cell input.
      h_prev, c_prev: (B, C, H, W) previous state, in x's dtype.
      weight: (4C, Cx+C, 3, 3) OIHW gate weight (gate order i, f, o, g
        along the output channels), used in x's dtype.
      bias: (4C,), added in fp32.
      plain: run the plain version on any device (the oracle).
    Returns:
      (h, c), each (B, C, H, W) in x's dtype.

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16)
    launch ``csrc/clstm_step.cu`` as ``cell_plan(..., kind="step")`` cuts
    it, on a copy of the weight in x's dtype (packed for the staged loop,
    OHWI for the FMA loop; the copy also casts), and count one launch in
    ``clstm_step.launches``."""
    _check(x, h_prev, c_prev, weight, bias)
    if plain or x.device.type == "cpu":
        return clstm_step_ref(x, h_prev, c_prev, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ConvLSTM step kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if any(not t.is_contiguous() for t in (x, h_prev, c_prev)):
        raise ValueError("ConvLSTM step kernel needs contiguous operands")
    b, cx, h, w = x.shape
    ch = h_prev.shape[1]
    plan = cell_plan(b, h, w, ch, cx, x.dtype, kind="step")
    wt = (packed_weight if plan.mma else ohwi_weight)(weight, x.dtype)
    bias32 = bias.float().contiguous()
    h_out = torch.empty_like(h_prev)
    c_out = torch.empty_like(h_prev)
    ws = workspace(plan, b, h, w, ch, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_clstm_step(
            x.data_ptr() if cx else None, h_prev.data_ptr(),
            c_prev.data_ptr(), wt.data_ptr(), bias32.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            0 if ws is None else ws.numel(), b, h, w, ch, cx,
            _DTYPE_CODES[x.dtype], *plan_args(plan), stream)
    if err != 0:
        raise RuntimeError(f"ConvLSTM step kernel launch failed: CUDA error "
                           f"{err}")
    clstm_step.launches += 1
    return h_out, c_out


clstm_step.launches = 0


def fused_convlstm_step(x, h_prev, c_prev, kernel, bias, plain: bool = False):
    """The JAX function's signature: x (B, H, W, Cx), h_prev and c_prev
    (B, H, W, C), kernel (3, 3, Cx+C, 4C) HWIO, bias (4C,); returns (h, c)
    (B, H, W, C) in x's dtype. h_prev and the kernel are cast to x's dtype,
    as the JAX function casts them, and so is c_prev (the JAX kernel reads
    it in its own dtype)."""
    dtype = x.dtype

    def nchw(t):
        return t.permute(0, 3, 1, 2).contiguous()

    h, c = clstm_step(nchw(x), nchw(h_prev.to(dtype)), nchw(c_prev.to(dtype)),
                      kernel.permute(3, 2, 0, 1), bias,
                      plain=plain)
    return h.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)
