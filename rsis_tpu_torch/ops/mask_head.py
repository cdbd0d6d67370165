"""Mask head: conv3x3 -> 1 channel of the align-corners 2x upsample.

Counterpart of ``rsis_tpu/ops/mask_head.py::mask_head_fused`` and
``rsis_tpu/ops/pallas_mask_head.py::mask_head_pallas`` (the Pallas
``_head_kernel`` / ``_head_kernel_vpu``). The decoder upsamples its finest
hidden state 2x (align_corners=True) and projects it to one channel of
mask logits with a 3x3 SAME conv whose padding is zero outside the
upsampled grid.

On a CUDA tensor ``mask_head_fused_kernel`` launches the hand-written
kernel ``csrc/mask_head.cu``; on a CPU tensor it runs ``mask_head_ref``,
the plain PyTorch version: conv2d over the upsample, in fp32, rounded once
to the input dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .upsample import upsample_bilinear_align_corners

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mask_head_ref(hs: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Plain version: hs (B, H, C, W), weight (1, C, 3, 3), bias (1,) ->
    (B, 2H, 2W, 1) logits in the dtype of hs."""
    _, h, _, w = hs.shape
    up = upsample_bilinear_align_corners(hs.permute(0, 2, 1, 3).float(),
                                         2 * h, 2 * w)
    out = F.conv2d(up, weight.float(), bias.float(), padding=1)
    return out.permute(0, 2, 3, 1).to(hs.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mask_head")
    lib.rsis_mask_head.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.rsis_mask_head.restype = ctypes.c_int
    return lib


def mask_head_fused_kernel(hs: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """conv3x3(upsample_2x_align_corners(h)) + bias, one output channel.

    Args:
      hs: (B, H, C, W) finest hidden states (the decode layout).
      weight: (1, C, 3, 3) conv weight; bias: (1,).
    Returns:
      (B, 2H, 2W, 1) mask logits in the dtype of hs.

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16
    hs, contiguous) launch ``csrc/mask_head.cu`` and count one launch in
    ``mask_head_fused_kernel.launches``."""
    b, h, c, w = hs.shape
    if tuple(weight.shape) != (1, c, 3, 3) or bias.numel() != 1:
        raise ValueError(f"weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={c}")
    if weight.device != hs.device or bias.device != hs.device:
        raise ValueError("all operands must be on one device")
    if hs.device.type == "cpu":
        return mask_head_ref(hs, weight, bias)
    if hs.device.type != "cuda":
        raise ValueError(f"no kernel for device {hs.device}")
    if hs.dtype not in _DTYPE_CODES:
        raise TypeError(f"mask head kernel takes float32 or bfloat16, "
                        f"not {hs.dtype}")
    if not hs.is_contiguous():
        raise ValueError("mask head kernel needs a contiguous hs")
    k9 = weight[0].permute(1, 2, 0).reshape(9, c).float().contiguous()
    b32 = bias.reshape(1).float().contiguous()
    out = torch.empty((b, 2 * h, 2 * w, 1), dtype=hs.dtype, device=hs.device)
    with torch.cuda.device(hs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_mask_head(hs.data_ptr(), k9.data_ptr(),
                                    b32.data_ptr(), out.data_ptr(), b, h, c,
                                    w, _DTYPE_CODES[hs.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mask head kernel launch failed: CUDA error "
                           f"{err}")
    mask_head_fused_kernel.launches += 1
    return out


mask_head_fused_kernel.launches = 0


class MaskHeadFunction(torch.autograd.Function):
    """Differentiable head for the training step: apply(hs, weight, bias)
    -> (B, 2H, 2W, 1) logits, as ``mask_head_fused_kernel``.

    Counterpart of ``rsis_tpu/ops/pallas_mask_head.py::make_mask_head_vjp``.
    The forward is the kernel (K2) on CUDA tensors; the backward is the
    pullback of the dense formulation ``mask_head_ref`` (fp32) through
    autograd. The head is linear in hs, so the pullback costs the
    transposed interpolation products and conv, nothing of the forward."""

    @staticmethod
    def forward(ctx, hs, weight, bias):
        ctx.save_for_backward(hs, weight, bias)
        return mask_head_fused_kernel(hs, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = mask_head_ref(*leaves)
            return torch.autograd.grad(out, leaves, grad)
