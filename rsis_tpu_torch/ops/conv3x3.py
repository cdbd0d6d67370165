"""Plain 3x3 SAME convolution in the (B, H, C, W) layout, packed weights.

Counterpart of ``rsis_tpu/ops/pallas_decode.py::conv3x3_rowmajor`` (the
Pallas ``_conv_kernel`` / ``_conv_kernel_dyfold``). The weight is packed
(Cout, 9 * Cin), tap-major and channel-minor, the h part of
``pack_cell_weights``; the halo is zero. Products accumulate in fp32 and
the result is stored once in the input dtype. The cell backward uses it
to pull the gate cotangents back through the gate convolution
(``conv3x3_pullback``: dx_pad and dh_prev from one launch).

On a CUDA tensor ``conv3x3_rowmajor`` and ``conv3x3_pullback`` launch the
hand-written kernel ``csrc/conv3x3.cu`` as ``conv3x3_plan`` cuts it; on a
CPU tensor they run the plain versions: ``F.conv2d`` on the channel-first
view, in fp32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build
from .fused_cell import (SM_COUNT, SMEM_LIMIT, _DTYPE_CODES,
                         _divisor_at_most, _unit_shape)


def conv3x3_rowmajor_ref(x: torch.Tensor, wt: torch.Tensor, *, cin: int,
                         cout: int) -> torch.Tensor:
    """Plain version: x (B, H, Cin, W), wt (Cout, 9 * Cin) -> (B, H, Cout,
    W) in x's dtype, computed in fp32."""
    w = wt.float().reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    out = F.conv2d(x.permute(0, 2, 1, 3).float(), w, padding=1)
    return out.to(x.dtype).permute(0, 2, 1, 3).contiguous()


def conv3x3_pullback_ref(dg: torch.Tensor, wpack: torch.Tensor, *, cx: int,
                         ch: int):
    """Plain version of ``conv3x3_pullback``: the stacked output's first cx
    channels padded with a zero ring, and the rest."""
    out = conv3x3_rowmajor_ref(dg, wpack, cin=dg.shape[2], cout=cx + ch)
    dx_pad = (F.pad(out[:, :, :cx], (1, 1, 0, 0, 1, 1)) if cx else None)
    return dx_pad, out[:, :, cx:].contiguous()


# The kernel's instantiations: m-tiles of 16 pixels and n-tiles of 8
# output channels a warp.
WARP_M_TILES = (4, 2, 1)
WARP_N_TILES = (8, 6, 4, 3, 2, 1)
CHUNK_CHANNELS = (64, 32, 16)


@dataclasses.dataclass(frozen=True)
class Conv3x3Plan:
    """How ``csrc/conv3x3.cu`` cuts one convolution.

    mma: the tensor-core loop (bf16, Cin % 16 == 0, Cout and W multiples of
    8) with warp tiles of wm m-tiles (16 pixels of one row) x wn n-tiles (8
    output channels), warps_m x warps_n warps a block, units of ``rows``
    x ``tw`` output pixels (rows * tw == 16 wm warps_m), K-chunks of all
    nine taps x ``cc`` input channels in a ring of ``stages``, the chunks
    cut into ``splits`` parts (each writes an fp32 partial, summed in part
    order by a second launch) and the units dealt in order to ``groups``
    blocks per (output-channel tile, part); otherwise the FMA loop."""
    mma: bool
    wm: int = 0
    wn: int = 0
    warps_m: int = 0
    warps_n: int = 0
    rows: int = 0
    tw: int = 0
    cc: int = 0
    stages: int = 0
    splits: int = 1
    groups: int = 0

    @property
    def block_n(self) -> int:
        return 8 * self.wn * self.warps_n

    def units(self, b: int, h: int, w: int) -> int:
        return b * -(-h // self.rows) * -(-w // self.tw)

    def blocks(self, cout: int) -> int:
        return cout // self.block_n * self.splits * self.groups

    def smem_bytes(self, cin: int) -> int:
        """Dynamic shared memory of one block (the kernel's ``Smem``): the
        ring of raw dg rows, the weight slots (one when a block has one
        chunk), the transposed halo or the bf16 output tile, whichever is
        larger, and 16 bytes of trash."""
        raw = (self.rows + 2) * self.cc * (self.tw + 24)
        wgt = self.block_n * (9 * self.cc + 8)
        wslots = 1 if cin // self.cc // self.splits == 1 else self.stages
        halo = (self.rows + 2) * (self.tw + 2) * (self.cc + 8)
        out = 0 if self.splits > 1 else self.block_n * (
            self.rows * self.tw + 8)
        return 2 * (self.stages * raw + wslots * wgt + max(halo, out) + 8)

    def workspace_floats(self, b: int, h: int, w: int, cout: int) -> int:
        return self.splits * b * h * cout * w if self.splits > 1 else 0


def conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int,
                 dtype: torch.dtype) -> Conv3x3Plan:
    """The launch plan of K3 for x (b, h, cin, w) and cout outputs.

    Tensor cores (bf16, cin % 16 == 0, cout and w multiples of 8), one
    block of 8 warps an SM:
      - the block tile: P = 512 pixels where Cout <= 48, else 256, both
        cut to a power of two within one image; then the most output
        channels (a divisor of Cout, at most 24576 / P: 96 accumulators a
        thread), split into warps of wn n-tiles (the widest) x wm m-tiles
        with wm <= 4 and wm wn <= 24; n-tiles of blocks cover the rest of
        Cout;
      - wm halved (down to 2) where the units would leave half the SMs
        idle;
      - the unit's rows x tw: the fewest input bytes staged per useful
        output pixel, then the widest (``_unit_shape``);
      - the K-chunk: the most channels (64, 32, 16) whose 2-stage ring
        fits, with the split below; a 3-stage ring where it fits;
      - the split: where units x channel tiles leave SMs idle, the chunks
        are cut into the most parts (a divisor of the chunk count) that
        keep the blocks within one wave, one unit a block; otherwise one
        part and the units dealt to at most one block an SM.
    FMA otherwise (fp32, other widths): the kernel's own FMA launch."""
    if not (dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0
            and w % 8 == 0):
        return Conv3x3Plan(mma=False)
    image = h * -(-w // 16) * 16
    pixels = 512 if cout <= 48 else 256
    while pixels > 16 and pixels > image:
        pixels //= 2
    best = None
    for wn in WARP_N_TILES:
        for warps_n in (1, 2, 4, 8):
            nb = 8 * wn * warps_n
            warps_m = min(8 // warps_n, pixels // 16)
            wm = pixels // (16 * warps_m)
            if (cout % nb or nb * pixels > max(24576, 8 * pixels) or wm > 4
                    or wm * wn > 24):
                continue
            if best is None or (nb, wn) > best[0]:
                best = ((nb, wn), (wn, warps_n, warps_m, wm))
    wn, warps_n, warps_m, wm = best[1]
    n_tiles = cout // (8 * wn * warps_n)

    def units(wm_):
        rows, tw = _unit_shape(16 * warps_m * wm_, h, w)
        return b * -(-h // rows) * -(-w // tw)

    while wm > 2 and 2 * units(wm) * n_tiles <= SM_COUNT:
        wm //= 2
    rows, tw = _unit_shape(16 * warps_m * wm, h, w)
    n_units = b * -(-h // rows) * -(-w // tw)
    plan = None
    for cc in CHUNK_CHANNELS:
        if cin % cc:
            continue
        if n_units * n_tiles < SM_COUNT:
            splits = _divisor_at_most(cin // cc,
                                      SM_COUNT // (n_units * n_tiles))
            groups = n_units
        else:
            splits, groups = 1, min(n_units, SM_COUNT)
        plan = Conv3x3Plan(True, wm, wn, warps_m, warps_n, rows, tw, cc, 2,
                           splits, groups)
        if plan.smem_bytes(cin) <= SMEM_LIMIT:
            break
    if plan.smem_bytes(cin) > SMEM_LIMIT:
        raise ValueError(f"no K3 chunk fits {SMEM_LIMIT} bytes of shared "
                         f"memory at Cin={cin}, Cout={cout}")
    three = dataclasses.replace(plan, stages=3)
    return three if three.smem_bytes(cin) <= SMEM_LIMIT else plan


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    lib.rsis_conv3x3.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 18
        + [ctypes.c_void_p])
    lib.rsis_conv3x3.restype = ctypes.c_int
    return lib


def _check(x, wt, cin, cout):
    if x.dim() != 4 or x.shape[2] != cin or tuple(wt.shape) != (cout,
                                                                9 * cin):
        raise ValueError(f"x {tuple(x.shape)} / wt {tuple(wt.shape)} do not "
                         f"fit cin={cin}, cout={cout}")
    if wt.device != x.device:
        raise ValueError("all operands must be on one device")


def _launch(x, wt, dx_pad, dh, cin, cout, cx):
    """Launch csrc/conv3x3.cu on CUDA tensors: output channels below cx
    into dx_pad (with its ring), the rest into dh."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES or wt.dtype != x.dtype:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16 operands "
                        f"of one dtype, not {x.dtype} and {wt.dtype}")
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("conv3x3 kernel needs contiguous operands")
    b, h, _, w = x.shape
    plan = conv3x3_plan(b, h, w, cin, cout, x.dtype)
    n_ws = plan.workspace_floats(b, h, w, cout)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
          if n_ws else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_conv3x3(
            x.data_ptr(), wt.data_ptr(),
            None if dx_pad is None else dx_pad.data_ptr(), dh.data_ptr(),
            None if ws is None else ws.data_ptr(), n_ws, b, h, w, cin, cout,
            cx, _DTYPE_CODES[x.dtype], int(plan.mma), plan.wm, plan.wn,
            plan.warps_m, plan.warps_n, plan.rows, plan.tw, plan.cc,
            plan.stages, plan.splits, plan.groups, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    conv3x3_rowmajor.launches += 1


def conv3x3_rowmajor(x: torch.Tensor, wt: torch.Tensor, *, cin: int,
                     cout: int) -> torch.Tensor:
    """3x3 SAME conv of x (B, H, Cin, W) with the packed weight
    wt (Cout, 9 * Cin); returns (B, H, Cout, W) in x's dtype.

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16,
    both alike, contiguous) launch ``csrc/conv3x3.cu`` and count one launch
    in ``conv3x3_rowmajor.launches``, the kernel's count, which
    ``conv3x3_pullback`` shares."""
    _check(x, wt, cin, cout)
    if x.device.type == "cpu":
        return conv3x3_rowmajor_ref(x, wt, cin=cin, cout=cout)
    b, h, _, w = x.shape
    out = torch.empty((b, h, cout, w), dtype=x.dtype, device=x.device)
    _launch(x, wt, None, out, cin, cout, 0)
    return out


conv3x3_rowmajor.launches = 0


def conv3x3_pullback(dg: torch.Tensor, wpack: torch.Tensor, *, cx: int,
                     ch: int):
    """The cell backward's pullback conv of dg (B, H, 4C, W) with the
    packed transposed weight wpack (Cx + C, 36 C): returns (dx_pad (B,
    H+2, Cx, W+2) with a zero ring, or None when cx == 0; dh_prev (B, H,
    C, W)), both contiguous in dg's dtype: the slice and pad of
    ``conv3x3_rowmajor``'s stacked output, written by one launch.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/conv3x3.cu`` and count one launch in
    ``conv3x3_rowmajor.launches``."""
    cin = dg.shape[2] if dg.dim() == 4 else -1
    _check(dg, wpack, cin, cx + ch)
    if dg.device.type == "cpu":
        return conv3x3_pullback_ref(dg, wpack, cx=cx, ch=ch)
    b, h, _, w = dg.shape
    dx_pad = (torch.empty((b, h + 2, cx, w + 2), dtype=dg.dtype,
                          device=dg.device) if cx else None)
    dh = torch.empty((b, h, ch, w), dtype=dg.dtype, device=dg.device)
    _launch(dg, wpack, dx_pad, dh, cin, cx + ch, cx)
    return dx_pad, dh
