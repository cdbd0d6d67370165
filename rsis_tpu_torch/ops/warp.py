"""Exact nearest-neighbour affine warp of an image and its id plane.

Counterpart of ``rsis_tpu/ops/pallas_warp.py`` (``_coef_from_matrices``,
``nearest_index_maps``, ``affine_warp_planes``: the Pallas ``_pass1_kernel``
and ``_pass2_kernel``). Per sample, from a (3, 3) centred-coordinate
matrix and a flip flag, every output pixel (r, c) reads the source pixel

  R  = clamp(round(p*r + (q*c + m)), 0, H-1)
  C  = clamp(round(v*r + (u*c + o)), 0, W-1);   C' = (W-1) - C on a flip

in float32 with exactly these expression trees and round half to even.
The flip is the integer reflection of the final column, which equals
flipping the image before the warp.

``affine_warp`` takes the train step's layout: the image (B, H, W, C) in
any float dtype (bf16 on the train path) and the id plane (B, H, W) uint8,
read directly (no (B, C+1, H, W) stack as in the JAX path). It computes
the coefficients once, in torch float32, and ``warp_by_coefficients``
hands the same coefficients to either version: on a CUDA tensor the
hand-written kernel ``csrc/warp.cu`` (a warp copies a segment of
32 x 16 output pixels of one row, all its gathers in flight at once, then
stores it in 16-byte chunks; the gather and the widths from
``warp_plan``), on a CPU tensor ``affine_warp_ref``, the plain
version (index maps and a gather), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# pixels a lane of the kernel takes (kV in csrc/warp.cu), 32 times that a
# warp, where C is 1-4
WARP_LANE_PIXELS = 16
WARP_SEGMENTS = 4                  # warps (segments) a block
# how the kernel gathers a segment's image elements: element q of the
# segment by lane q % 32 (each load instruction 32 consecutive elements),
# or each of a lane's pixels as one 4-, 8- or 16-byte load
WARP_LOADS = ("elements", "vector")


@dataclasses.dataclass(frozen=True)
class WarpPlan:
    """How ``csrc/warp.cu`` cuts one warp.

    A warp owns a segment of 32 ``v`` consecutive output pixels of one row
    (a row's last segment the W % 32 v that are left), lane l the source
    indices of its pixels l + 32 k, k < v, and their ids; it gathers the
    segment's image as ``load`` (of WARP_LOADS) says, stages it in shared
    memory in output order and stores the segment's image bytes in
    ``img_store``-byte chunks and its ids in ``ids_store``-byte chunks,
    lane q the chunks q, q + 32, ... (narrower chunks for a segment's last
    bytes). v = 1: one pixel a thread, for C > 4. The grid is
    ceil(H * segments / 4) x B blocks of four warps."""
    v: int
    img_store: int
    ids_store: int
    load: str

    def segments(self, w: int) -> int:
        """Warps a row."""
        return -(-w // (32 * self.v))

    def blocks(self, b: int, h: int, w: int) -> int:
        if self.v == 1:
            return b * -(-h * w // 256)
        return b * -(-h * self.segments(w) // WARP_SEGMENTS)


def _coef_from_matrices(matrices: torch.Tensor, h: int, w: int,
                        flip: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 3, 3) centred-coordinate matrices -> (B, 10) float32
    [p, q, m, u, v, o, u', v', flag, o'] absolute-index coefficients, with
    the JAX function's float32 expression trees in its order. Only p, q,
    m, u, v, o and flag enter the warp; u', v', o' steered the TPU
    kernel's candidate windows and are kept for parity."""
    a = matrices[:, :2, :2].float()
    b = matrices[:, :2, 2].float()
    cr = torch.tensor(h / 2.0 - 0.5, dtype=torch.float32)
    cc = torch.tensor(w / 2.0 - 0.5, dtype=torch.float32)
    p = a[:, 0, 0]
    q = a[:, 0, 1]
    m = (b[:, 0] + cr) - (a[:, 0, 0] * cr + a[:, 0, 1] * cc)
    u = a[:, 1, 1]
    v = a[:, 1, 0]
    o = (b[:, 1] + cc) - (a[:, 1, 0] * cr + a[:, 1, 1] * cc)
    flag = (torch.zeros_like(p) if flip is None
            else flip.to(p.device, torch.float32))
    s = 1.0 - 2.0 * flag
    uf = u * s
    vf = v * s
    of = flag * ((w - 1) - o) + (1.0 - flag) * o
    vp = vf / p
    up = uf - vp * q
    opp = of - vp * m
    return torch.stack([p, q, m, u, v, o, up, vp, flag, opp], dim=1)


def nearest_index_maps(coef: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 10) coefficients -> (B, H*W) int64 flat source index of every
    output pixel."""
    rows = torch.arange(h, dtype=torch.float32, device=coef.device)
    rows = rows[:, None].expand(h, w).reshape(1, -1)
    cols = torch.arange(w, dtype=torch.float32, device=coef.device)
    cols = cols[None, :].expand(h, w).reshape(1, -1)
    p, q, m, u, v, o = (coef[:, i:i + 1] for i in range(6))
    ri = torch.clamp(torch.round(p * rows + (q * cols + m)), 0, h - 1).long()
    ci = torch.clamp(torch.round(v * rows + (u * cols + o)), 0, w - 1).long()
    ci = torch.where(coef[:, 8:9] > 0, (w - 1) - ci, ci)
    return ri * w + ci


def affine_warp_ref(image: torch.Tensor, ids: torch.Tensor,
                    coef: torch.Tensor):
    """Plain version: the index maps and one gather of each tensor."""
    b, h, w, c = image.shape
    idx = nearest_index_maps(coef, h, w)
    img = torch.gather(image.reshape(b, h * w, c), 1,
                       idx[:, :, None].expand(b, h * w, c))
    return (img.reshape(b, h, w, c),
            torch.gather(ids.reshape(b, h * w), 1, idx).reshape(b, h, w))


def _pow2_divisor(n: int, cap: int = 16) -> int:
    """The largest power of two that divides n, at most cap."""
    return min(cap, n & -n) if n else cap


def address_alignment(t: torch.Tensor) -> int:
    """The power-of-two alignment of a tensor's data address, at most 16
    bytes."""
    return _pow2_divisor(t.data_ptr())


def warp_plan(w: int, c: int, elem_bytes: int,
              img_align: int = 16) -> WarpPlan:
    """The launch plan of K7 for an NHWC image of width w and c channels of
    elem_bytes bytes whose data address is aligned to img_align bytes (the
    outputs are fresh and 16-byte aligned).

      - v: WARP_LANE_PIXELS pixels a lane where C is 1-4, else 1 (the
        kernel decides this from C);
      - img_store: the widest of 16, 8, 4, 2 bytes that divides the row's
        image bytes (a segment's are a multiple of 16), so every segment
        starts aligned, at least one element: 16 for bf16 RGB at W % 8 ==
        0;
      - ids_store: likewise of 16, 8, 4, 2, 1 for the row's W id bytes;
      - load: "vector" where a source pixel's c elements are 4, 8 or 16
        bytes and the image's address is aligned to that size, else
        "elements" (bf16 RGB: 6-byte pixels)."""
    if c > 4:
        return WarpPlan(1, elem_bytes, 1, "elements")
    img_store = max(elem_bytes, _pow2_divisor(w * c * elem_bytes))
    pixel = c * elem_bytes
    vector = pixel in (4, 8, 16) and img_align % pixel == 0
    return WarpPlan(WARP_LANE_PIXELS, img_store, _pow2_divisor(w),
                    "vector" if vector else "elements")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("warp")
    lib.rsis_warp.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                              + [ctypes.c_void_p])
    lib.rsis_warp.restype = ctypes.c_int
    return lib


def warp_coefficients(image: torch.Tensor, matrices: torch.Tensor,
                      flip: torch.Tensor | None) -> torch.Tensor:
    """The (B, 10) coefficients of ``affine_warp``, on the image's
    device."""
    h, w = image.shape[1], image.shape[2]
    flip = None if flip is None else flip.to(image.device)
    return _coef_from_matrices(matrices.to(image.device), h, w, flip)


def affine_warp(image: torch.Tensor, ids: torch.Tensor,
                matrices: torch.Tensor, flip: torch.Tensor | None = None,
                plain: bool = False):
    """Warp an image and its id plane by one matrix per sample.

    Args:
      image: (B, H, W, C) float (bf16 on the train path).
      ids: (B, H, W) uint8 id plane.
      matrices: (B, 3, 3) centred-coordinate affine matrices
        (``data/device_aug.sample_affine_matrices``).
      flip: optional (B,) bool, a horizontal flip before the warp.
      plain: run the plain version on any device.
    Returns:
      (image_out (B, H, W, C), ids_out (B, H, W)), the nearest-neighbour
      gathers of both at the same source pixels.

    Computes the coefficients (``warp_coefficients``) and hands them to
    ``warp_by_coefficients``."""
    if image.dim() != 4 or tuple(matrices.shape) != (image.shape[0], 3, 3):
        raise ValueError(f"need image (B, H, W, C) and matrices (B, 3, 3), "
                         f"got {tuple(image.shape)} and "
                         f"{tuple(matrices.shape)}")
    return warp_by_coefficients(image, ids,
                                warp_coefficients(image, matrices, flip),
                                plain=plain)


def warp_by_coefficients(image: torch.Tensor, ids: torch.Tensor,
                         coef: torch.Tensor, plain: bool = False):
    """The warp of ``affine_warp`` from its (B, 10) float32 coefficients.

    CPU tensors (or plain=True) take the plain version. CUDA tensors
    (float32 or bfloat16 image, contiguous, at any address) launch
    ``csrc/warp.cu`` with ``warp_plan``'s plan and count one launch in
    ``warp_by_coefficients.launches``."""
    if image.dim() != 4 or tuple(ids.shape) != tuple(image.shape[:3]):
        raise ValueError(f"need image (B, H, W, C) and ids (B, H, W), got "
                         f"{tuple(image.shape)} and {tuple(ids.shape)}")
    b, h, w, c = image.shape
    if ids.dtype != torch.uint8:
        raise TypeError(f"the id plane must be uint8, not {ids.dtype}")
    if tuple(coef.shape) != (b, 10) or coef.dtype != torch.float32:
        raise ValueError(f"coef must be ({b}, 10) float32")
    if ids.device != image.device or coef.device != image.device:
        raise ValueError("image, ids and coef must be on one device")
    if plain or image.device.type == "cpu":
        return affine_warp_ref(image, ids, coef)
    if image.device.type != "cuda":
        raise ValueError(f"no kernel for device {image.device}")
    if image.dtype not in _ELEM_BYTES:
        raise TypeError(f"warp kernel takes float32 or bfloat16, not "
                        f"{image.dtype}")
    if not all(t.is_contiguous() for t in (image, ids, coef)):
        raise ValueError("warp kernel needs contiguous image, ids and coef")
    img_out = torch.empty_like(image)
    ids_out = torch.empty_like(ids)
    if min(address_alignment(img_out), address_alignment(ids_out)) < 16:
        raise RuntimeError("the warp's outputs are not 16-byte aligned")
    elem = _ELEM_BYTES[image.dtype]
    plan = warp_plan(w, c, elem, address_alignment(image))
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_warp(image.data_ptr(), ids.data_ptr(),
                               coef.data_ptr(), img_out.data_ptr(),
                               ids_out.data_ptr(), b, h, w, c, elem,
                               plan.img_store, plan.ids_store,
                               int(plan.load == "vector"), stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
    warp_by_coefficients.launches += 1
    return img_out, ids_out


warp_by_coefficients.launches = 0
