"""Mask head: conv3x3 -> 1 channel of the align-corners 2x upsample.

Counterpart of ``rsis_tpu/ops/mask_head.py::mask_head_fused`` and
``rsis_tpu/ops/pallas_mask_head.py::mask_head_pallas`` /
``mask_head_pallas_t`` (the Pallas ``_head_kernel`` /
``_head_kernel_vpu``). The decoder upsamples its finest hidden state 2x
(align_corners=True) and projects it to one channel of mask logits with a
3x3 SAME conv whose padding is zero outside the upsampled grid.

On a CUDA tensor ``mask_head_fused_kernel`` ((B, H, C, W) input, the
row-major decode) and ``mask_head_nchw_kernel`` ((B, C, H, W), the plain
decoder) launch the hand-written kernel ``csrc/mask_head.cu`` as
``mask_head_plan`` cuts it, both counted in
``mask_head_fused_kernel.launches``; on a CPU tensor they run the plain
PyTorch version: conv2d over the upsample, in fp32, rounded once to the
input dtype.

``slab=(row0, full_h)`` runs the head on a slab of an image whose rows are
sharded (``evals/streaming.py``): the input holds the slab's rows of an
image of full_h rows, from global row row0, plus one halo row above and
below (zeros where outside the image), and the output is the slab's own
rows of the full image's logits. The kernel maps rows through the
upsample by their global index; on the unsharded head (row0 0, full_h
the height, no halo) its arithmetic is the unchanged one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build
from .fused_cell import SM_COUNT
from .upsample import (interp_matrix, interp_window,
                       upsample_bilinear_align_corners)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mask_head_nchw_ref(ht: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, slab=None) -> torch.Tensor:
    """Plain version: ht (B, C, H, W), weight (1, C, 3, 3), bias (1,) ->
    (B, 1, 2H, 2W) logits in the dtype of ht. With slab = (row0, full_h),
    ht holds H - 2 slab rows and their two halo rows, and the output the
    slab's 2(H - 2) rows."""
    _, _, h, w = ht.shape
    if slab is None:
        up = upsample_bilinear_align_corners(ht.float(), 2 * h, 2 * w)
        out = F.conv2d(up, weight.float(), bias.float(), padding=1)
        return out.to(ht.dtype)
    row0, full_h = slab
    n = h - 2
    # the slab's upsampled rows and the conv's halo row on each side
    rm = interp_window(full_h, 2 * full_h, 2 * row0 - 1, 2 * n + 2,
                       row0 - 1, n + 2, torch.float32, ht.device)
    cm = interp_matrix(w, 2 * w, torch.float32, ht.device)
    up = torch.matmul(torch.matmul(rm, ht.float()), cm.t())
    out = F.conv2d(up, weight.float(), bias.float(), padding=(0, 1))
    return out.to(ht.dtype)


def mask_head_ref(hs: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, slab=None) -> torch.Tensor:
    """Plain version: hs (B, H, C, W), weight (1, C, 3, 3), bias (1,) ->
    (B, 2H, 2W, 1) logits in the dtype of hs (slab: as
    ``mask_head_nchw_ref``)."""
    out = mask_head_nchw_ref(hs.permute(0, 2, 1, 3), weight, bias, slab)
    return out.permute(0, 2, 3, 1)


# The kernel's columns a thread (one load a channel) and its largest block.
HEAD_VECTORS = (4, 2, 1)
HEAD_MAX_WARPS = 8
HEAD_ROWS = (32, 16, 8, 4, 2, 1)
# the fewest warps a launch should have before its rows a block shrink:
# about one wave at the 8 warps an SM that the kernel's registers allow;
# the head's shapes then take the fastest rows of chip_k5_step.py
# --k2-sweep (32 at 512x1024 B=32, 4 at B=4, 8 at 256x512 B=32)
HEAD_WARP_TARGET = 7 * SM_COUNT


@dataclasses.dataclass(frozen=True)
class MaskHeadPlan:
    """How ``csrc/mask_head.cu`` cuts one head.

    A thread owns ``v`` consecutive input columns (one v-wide load a
    channel and row) and walks down ``rows`` input rows, finishing one
    output-row pair a row; a block has ``warps`` warps side by side along
    W. Where 32 warps v >= W a block covers whole rows; wider rows are cut
    into strips ``col_step`` columns apart whose first and last thread are
    halo threads (they load and contract, they do not store). The grid is
    B x ceil(H / rows) x strips blocks."""
    v: int
    rows: int
    warps: int

    @property
    def threads(self) -> int:
        return 32 * self.warps

    def strips(self, w: int) -> int:
        if self.threads * self.v >= w:
            return 1
        return -(-w // self.col_step(w))

    def col_step(self, w: int) -> int:
        """Columns between the first columns of two strips (0 for one)."""
        if self.threads * self.v >= w:
            return 0
        return (self.threads - 2) * self.v

    def blocks(self, b: int, h: int, w: int) -> int:
        return b * -(-h // self.rows) * self.strips(w)


def head_vector(w: int, dtype: torch.dtype, strides, align: int = 16) -> int:
    """The widest v of HEAD_VECTORS that W, the strides (elements) and the
    data's address alignment (bytes) allow."""
    size = torch.empty((), dtype=dtype).element_size()
    for v in HEAD_VECTORS:
        if (w % v == 0 and all(s % v == 0 for s in strides)
                and align % (v * size) == 0):
            return v
    return 1


@functools.lru_cache(maxsize=256)
def mask_head_plan(b: int, h: int, c: int, w: int, dtype: torch.dtype,
                   strides: tuple, align: int = 16) -> MaskHeadPlan:
    """The launch plan of K2 for an input of b images of c channels, h x w,
    with strides (batch, channel, row) in elements, W contiguous, at a
    data address aligned to ``align`` bytes.

      - v: the widest of 4, 2, 1 columns a thread that W, the strides and
        the address allow (8- or 16-byte loads at 4; odd W takes 1);
      - warps: enough to cover a row, ceil(W / 32 v), at most 8;
      - rows: the most of 32, 16, 8, 4, 2, 1 (at most H) with which the
        launch has HEAD_WARP_TARGET warps, else 1: each block walks its
        rows plus two halo rows, so rows shrink only where the grid would
        leave SMs short of warps (small B)."""
    v = head_vector(w, dtype, strides, align)
    warps = min(HEAD_MAX_WARPS, -(-w // (32 * v)))
    rows = 1
    for r in HEAD_ROWS:
        if r > h:
            continue
        plan = MaskHeadPlan(v, r, warps)
        if plan.blocks(b, h, w) * warps >= HEAD_WARP_TARGET:
            rows = r
            break
    return MaskHeadPlan(v, rows, warps)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mask_head")
    lib.rsis_mask_head.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.rsis_mask_head.restype = ctypes.c_int
    return lib


def _check(x, weight, bias, c):
    if tuple(weight.shape) != (1, c, 3, 3) or bias.numel() != 1:
        raise ValueError(f"weight {tuple(weight.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={c}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("all operands must be on one device")


def _launch(x, weight, bias, out, b, h, c, w, strides, slab=None):
    """One K2 launch on x (CUDA, fp32 or bf16, W contiguous, strides
    (batch, channel, row) in elements) into out (B, 2H, 2W memory); with
    slab = (row0, full_h), x's first row is the halo row above h slab
    rows."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"mask head kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("mask head kernel needs a contiguous input")
    wt = weight.float().contiguous()
    b32 = bias.reshape(1).float().contiguous()
    row0, full_h = slab or (0, h)
    # the slab's first row; its halo rows lie one row stride around it
    ptr = x.data_ptr() + (strides[2] * x.element_size() if slab else 0)
    align = ptr & -ptr & 15 or 16
    plan = mask_head_plan(b, h, c, w, x.dtype, strides, align)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_mask_head(
            ptr, wt.data_ptr(), b32.data_ptr(), out.data_ptr(), b,
            h, c, w, *strides, _DTYPE_CODES[x.dtype], plan.v, plan.rows,
            plan.warps, row0, full_h, stream)
    if err != 0:
        raise RuntimeError(f"mask head kernel launch failed: CUDA error "
                           f"{err}")
    mask_head_fused_kernel.launches += 1
    return out


def _slab_rows(h: int, slab) -> int:
    if slab is None:
        return h
    if h < 3:
        raise ValueError(f"a slab needs its two halo rows and one row; "
                         f"got {h} rows")
    return h - 2


def mask_head_fused_kernel(hs: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, slab=None) -> torch.Tensor:
    """conv3x3(upsample_2x_align_corners(h)) + bias, one output channel.

    Args:
      hs: (B, H, C, W) finest hidden states (the decode layout).
      weight: (1, C, 3, 3) conv weight; bias: (1,).
      slab: (row0, full_h) for a slab of an H-sharded image: hs holds its
        H - 2 rows and a halo row above and below (module docstring).
    Returns:
      (B, 2H, 2W, 1) mask logits in the dtype of hs (slab: 2(H - 2) rows).

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16
    hs, contiguous) launch ``csrc/mask_head.cu`` and count one launch in
    ``mask_head_fused_kernel.launches``."""
    b, h, c, w = hs.shape
    _check(hs, weight, bias, c)
    n = _slab_rows(h, slab)
    if hs.device.type == "cpu":
        return mask_head_ref(hs, weight, bias, slab)
    out = torch.empty((b, 2 * n, 2 * w, 1), dtype=hs.dtype, device=hs.device)
    return _launch(hs, weight, bias, out, b, n, c, w, (h * c * w, w, c * w),
                   slab)


mask_head_fused_kernel.launches = 0


def mask_head_nchw_kernel(ht: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, slab=None) -> torch.Tensor:
    """The head on channel-planes-major input, the counterpart of
    ``mask_head_pallas_t``: the plain decoder's last hidden state.

    Args:
      ht: (B, C, H, W) finest hidden states (NCHW).
      weight: (1, C, 3, 3) conv weight; bias: (1,).
      slab: as ``mask_head_fused_kernel``'s.
    Returns:
      (B, 1, 2H, 2W) mask logits in the dtype of ht (slab: 2(H - 2) rows).

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16
    ht, contiguous) launch ``csrc/mask_head.cu`` and count one launch in
    ``mask_head_fused_kernel.launches``."""
    b, c, h, w = ht.shape
    _check(ht, weight, bias, c)
    n = _slab_rows(h, slab)
    if ht.device.type == "cpu":
        return mask_head_nchw_ref(ht, weight, bias, slab)
    out = torch.empty((b, 1, 2 * n, 2 * w), dtype=ht.dtype, device=ht.device)
    return _launch(ht, weight, bias, out, b, n, c, w, (c * h * w, h * w, w),
                   slab)


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
