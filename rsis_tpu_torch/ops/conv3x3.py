"""Plain 3x3 SAME convolution in the (B, H, C, W) layout, packed weights.

Counterpart of ``rsis_tpu/ops/pallas_decode.py::conv3x3_rowmajor`` (the
Pallas ``_conv_kernel`` / ``_conv_kernel_dyfold``). The weight is packed
(Cout, 9 * Cin), tap-major and channel-minor, the h part of
``pack_cell_weights``; the halo is zero. Products accumulate in fp32 and
the result is stored once in the input dtype. The cell backward uses it
to pull the gate cotangents back through the gate convolution.

On a CUDA tensor ``conv3x3_rowmajor`` launches the hand-written kernel
``csrc/conv3x3.cu``; on a CPU tensor it runs ``conv3x3_rowmajor_ref``, the
plain version: ``F.conv2d`` on the channel-first view, in fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .fused_cell import _DTYPE_CODES


def conv3x3_rowmajor_ref(x: torch.Tensor, wt: torch.Tensor, *, cin: int,
                         cout: int) -> torch.Tensor:
    """Plain version: x (B, H, Cin, W), wt (Cout, 9 * Cin) -> (B, H, Cout,
    W) in x's dtype, computed in fp32."""
    w = wt.float().reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    out = F.conv2d(x.permute(0, 2, 1, 3).float(), w, padding=1)
    return out.to(x.dtype).permute(0, 2, 1, 3).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    lib.rsis_conv3x3.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
    lib.rsis_conv3x3.restype = ctypes.c_int
    return lib


def conv3x3_rowmajor(x: torch.Tensor, wt: torch.Tensor, *, cin: int,
                     cout: int) -> torch.Tensor:
    """3x3 SAME conv of x (B, H, Cin, W) with the packed weight
    wt (Cout, 9 * Cin); returns (B, H, Cout, W) in x's dtype.

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16,
    both alike, contiguous) launch ``csrc/conv3x3.cu`` and count one launch
    in ``conv3x3_rowmajor.launches``."""
    b, h, c_dim, w = x.shape
    if c_dim != cin or tuple(wt.shape) != (cout, 9 * cin):
        raise ValueError(f"x {tuple(x.shape)} / wt {tuple(wt.shape)} do not "
                         f"fit cin={cin}, cout={cout}")
    if wt.device != x.device:
        raise ValueError("all operands must be on one device")
    if x.device.type == "cpu":
        return conv3x3_rowmajor_ref(x, wt, cin=cin, cout=cout)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES or wt.dtype != x.dtype:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16 operands "
                        f"of one dtype, not {x.dtype} and {wt.dtype}")
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("conv3x3 kernel needs contiguous operands")
    out = torch.empty((b, h, cout, w), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_conv3x3(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                  b, h, w, cin, cout, _DTYPE_CODES[x.dtype],
                                  stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    conv3x3_rowmajor.launches += 1
    return out


conv3x3_rowmajor.launches = 0
