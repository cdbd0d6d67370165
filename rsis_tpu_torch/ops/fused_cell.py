"""Fused ConvLSTM decode cell in the (B, H, C, W) layout.

Counterpart of ``rsis_tpu/ops/pallas_decode.py``: ``pack_cell_weights``
and ``fused_cell_rowmajor`` (the Pallas ``_cell_kernel`` /
``_cell_kernel_dyfold``). One cell step is

  gates = conv3x3_same([x_pad || h_prev], W) + S
  c = sig(f) * c_prev + sig(i) * tanh(g);   h = sig(o) * tanh(c)

with gate order i, f, o, g, the gate sum and the update in fp32, and h, c
stored in the input dtype. On a CUDA tensor ``fused_cell_rowmajor``
launches the hand-written kernel ``csrc/fused_cell.cu``; on a CPU tensor it
runs ``fused_cell_rowmajor_ref``, the plain PyTorch version of the same
arithmetic.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pack_cell_weights(weight: torch.Tensor, cx: int, ch: int,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(4C, Cx+C, 3, 3) OIHW gate weight -> (4C, 9*(Cx+C)) packed weight.

    Column order: the 9 x taps first (tap-major, channel-minor), then the
    9 h taps, as the kernel walks K. cx == 0 (cell 0) has only h taps."""
    w = weight.to(dtype)
    parts = []
    if cx > 0:
        parts.append(w[:, :cx].permute(0, 2, 3, 1).reshape(4 * ch, 9 * cx))
    parts.append(w[:, cx:].permute(0, 2, 3, 1).reshape(4 * ch, 9 * ch))
    return torch.cat(parts, dim=1).contiguous()


def _unpack(wt: torch.Tensor, cx: int, ch: int):
    """Packed (4C, 9*(Cx+C)) -> (OIHW x weight or None, OIHW h weight)."""
    g4 = 4 * ch
    wx = None
    if cx > 0:
        wx = wt[:, :9 * cx].reshape(g4, 3, 3, cx).permute(0, 3, 1, 2)
    wh = wt[:, 9 * cx:].reshape(g4, 3, 3, ch).permute(0, 3, 1, 2)
    return wx, wh


def gates_ref(h_prev: torch.Tensor, x_pad: torch.Tensor | None,
              s_term: torch.Tensor, wt: torch.Tensor, *, cx: int,
              ch: int) -> torch.Tensor:
    """The pre-activation gates, fp32 (B, 4C, H, W): the gate convolution
    of the upcast inputs plus S."""
    wx, wh = _unpack(wt.float(), cx, ch)
    h = h_prev.permute(0, 2, 1, 3).float()               # (B, C, H, W)
    gates = F.conv2d(h, wh, padding=1)
    if cx > 0:
        x = x_pad.permute(0, 2, 1, 3).float()            # (B, Cx, H+2, W+2)
        gates = gates + F.conv2d(x, wx)
    return gates + s_term.permute(0, 2, 1, 3).float()


def fused_cell_rowmajor_ref(h_prev: torch.Tensor, x_pad: torch.Tensor | None,
                            c_prev: torch.Tensor, s_term: torch.Tensor,
                            wt: torch.Tensor, *, cx: int, ch: int):
    """Plain PyTorch version of the kernel: the same products and update in
    fp32 (inputs upcast exactly), h and c rounded once to the input dtype."""
    dtype = h_prev.dtype
    gates = gates_ref(h_prev, x_pad, s_term, wt, cx=cx, ch=ch)
    i, f, o, g = torch.chunk(gates, 4, dim=1)
    c = (torch.sigmoid(f) * c_prev.permute(0, 2, 1, 3).float()
         + torch.sigmoid(i) * torch.tanh(g))
    h_new = torch.sigmoid(o) * torch.tanh(c)
    return (h_new.to(dtype).permute(0, 2, 1, 3).contiguous(),
            c.to(dtype).permute(0, 2, 1, 3).contiguous())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_cell")
    lib.rsis_fused_cell.argtypes = ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.rsis_fused_cell.restype = ctypes.c_int
    return lib


def _check(h_prev, x_pad, c_prev, s_term, wt, cx, ch):
    b, h, c_dim, w = h_prev.shape
    if c_dim != ch or tuple(c_prev.shape) != (b, h, ch, w):
        raise ValueError(f"h_prev {tuple(h_prev.shape)} / c_prev "
                         f"{tuple(c_prev.shape)} do not hold C={ch}")
    if tuple(s_term.shape) != (b, h, 4 * ch, w):
        raise ValueError(f"s_term {tuple(s_term.shape)} is not "
                         f"{(b, h, 4 * ch, w)}")
    if tuple(wt.shape) != (4 * ch, 9 * (cx + ch)):
        raise ValueError(f"wt {tuple(wt.shape)} is not "
                         f"{(4 * ch, 9 * (cx + ch))}")
    if cx == 0:
        if x_pad is not None:
            raise ValueError("cx == 0 takes no x_pad")
    elif x_pad is None or tuple(x_pad.shape) != (b, h + 2, cx, w + 2):
        raise ValueError(f"x_pad must be {(b, h + 2, cx, w + 2)}")
    tensors = [t for t in (h_prev, x_pad, c_prev, s_term, wt)
               if t is not None]
    if any(t.device != h_prev.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if any(t.dtype != h_prev.dtype for t in tensors):
        raise ValueError("all operands must share one dtype")


def fused_cell_rowmajor(h_prev: torch.Tensor, x_pad: torch.Tensor | None,
                        c_prev: torch.Tensor, s_term: torch.Tensor,
                        wt: torch.Tensor, *, cx: int, ch: int):
    """One fused ConvLSTM cell step in the (B, H, C, W) layout.

    Args:
      h_prev: (B, H, C, W) previous hidden state (unpadded).
      x_pad: (B, H+2, Cx, W+2) zero-padded up-input, or None when cx == 0.
      c_prev: (B, H, C, W).
      s_term: (B, H, 4C, W) step-constant skip contribution + bias.
      wt: (4C, 9*(Cx+C)) packed weight (pack_cell_weights).
    Returns:
      (h, c), each (B, H, C, W) in the dtype of h_prev.

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16,
    contiguous) launch ``csrc/fused_cell.cu`` and count one launch in
    ``fused_cell_rowmajor.launches``."""
    _check(h_prev, x_pad, c_prev, s_term, wt, cx, ch)
    if h_prev.device.type == "cpu":
        return fused_cell_rowmajor_ref(h_prev, x_pad, c_prev, s_term, wt,
                                       cx=cx, ch=ch)
    if h_prev.device.type != "cuda":
        raise ValueError(f"no kernel for device {h_prev.device}")
    if h_prev.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused cell kernel takes float32 or bfloat16, "
                        f"not {h_prev.dtype}")
    operands = (h_prev, x_pad, c_prev, s_term, wt)
    if any(t is not None and not t.is_contiguous() for t in operands):
        raise ValueError("fused cell kernel needs contiguous operands")
    b, h, _, w = h_prev.shape
    h_out = torch.empty_like(h_prev)
    c_out = torch.empty_like(h_prev)
    with torch.cuda.device(h_prev.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_fused_cell(
            h_prev.data_ptr(), None if x_pad is None else x_pad.data_ptr(),
            c_prev.data_ptr(), s_term.data_ptr(), wt.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), b, h, w, ch, cx,
            _DTYPE_CODES[h_prev.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused cell kernel launch failed: CUDA error "
                           f"{err}")
    fused_cell_rowmajor.launches += 1
    return h_out, c_out


fused_cell_rowmajor.launches = 0
