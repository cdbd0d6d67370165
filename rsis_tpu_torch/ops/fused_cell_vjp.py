"""Differentiable fused ConvLSTM cell: an autograd.Function over the kernels.

Counterpart of ``rsis_tpu/ops/pallas_decode_vjp.py`` (``_bwd_kernel``,
``_cell_backward_dgates``, ``_conv_transpose_rowmajor``,
``weight_grad_rowmajor`` / ``_weight_grad``, ``_cell_bwd_core``,
``make_fused_cell_vjp``). The forward is ``fused_cell_rowmajor`` (K1). The
backward keeps only the forward's inputs (rematerialisation: nothing
extra is stored per step) and runs three kernels:

  dg, dc_prev = cell_backward_dgates(...)       recompute the gates (K4)
  dwt         = weight_grad_rowmajor(h, x, dg)  sum_pixels dg (x) taps (K5)
  dx_pad, dh_prev = conv3x3_pullback(dg, flip(W)^T)  the pullback (K3)
  ds          = dg                              (S enters additively)

with the identities (gate order i, f, o, g)
  dc_tot = dc + dh * o * (1 - tanh(c)^2)
  d_i = dc_tot * g * i(1 - i);   d_f = dc_tot * c_prev * f(1 - f)
  d_o = dh * tanh(c) * o(1 - o); d_g = dc_tot * i * (1 - g^2)
  dc_prev = dc_tot * f
in fp32; dg and dc_prev are stored in the input dtype, the pullback conv
accumulates in fp32 and stores in the input dtype, and dwt accumulates in
fp32 and is cast to dg's dtype, as the JAX package rounds them. Each kernel
wrapper runs its plain version on CPU tensors and its kernel on CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import _build
from .conv3x3 import conv3x3_pullback
from .fused_cell import (_DTYPE_CODES, _check, cell_plan, fused_cell_rowmajor,
                         gates_ref, plan_args, workspace)


# ---- K4: gate recompute and gate cotangents ------------------------------

def cell_backward_dgates_ref(h_prev, x_pad, c_prev, s_term, wt, dh, dc, *,
                             cx: int, ch: int):
    """Plain version of K4: (dg (B, H, 4C, W), dc_prev (B, H, C, W)) in
    the input dtype, computed in fp32."""
    dtype = h_prev.dtype
    gates = gates_ref(h_prev, x_pad, s_term, wt, cx=cx, ch=ch)
    i_p, f_p, o_p, g_p = torch.chunk(gates, 4, dim=1)
    i, f, o = torch.sigmoid(i_p), torch.sigmoid(f_p), torch.sigmoid(o_p)
    g = torch.tanh(g_p)

    def nchw(t):
        return t.permute(0, 2, 1, 3).float()

    cp, dhv = nchw(c_prev), nchw(dh)
    c = f * cp + i * g
    tc = torch.tanh(c)
    dc_tot = nchw(dc) + dhv * o * (1.0 - tc * tc)
    dg = torch.cat([dc_tot * g * i * (1.0 - i),
                    dc_tot * cp * f * (1.0 - f),
                    dhv * tc * o * (1.0 - o),
                    dc_tot * i * (1.0 - g * g)], dim=1)
    return (dg.to(dtype).permute(0, 2, 1, 3).contiguous(),
            (dc_tot * f).to(dtype).permute(0, 2, 1, 3).contiguous())


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("cell_bwd")
    lib.rsis_cell_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 18
        + [ctypes.c_void_p])
    lib.rsis_cell_bwd.restype = ctypes.c_int
    return lib


def _kernel_operands(name, tensors, dtype):
    """Raise unless the CUDA kernel takes these operands."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    if any(t is not None and not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous operands")


def cell_backward_dgates(h_prev, x_pad, c_prev, s_term, wt, dh, dc, *,
                         cx: int, ch: int):
    """Gate cotangents of one cell step: recompute the gates from the
    forward inputs and apply the identities to the output cotangents dh,
    dc (B, H, C, W). Returns (dg (B, H, 4C, W), dc_prev (B, H, C, W)) in
    the input dtype.

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16,
    contiguous) launch ``csrc/cell_bwd.cu`` as ``cell_plan(...,
    kind="backward")`` cuts it and count one launch in
    ``cell_backward_dgates.launches``."""
    _check(h_prev, x_pad, c_prev, s_term, wt, cx, ch)
    for t in (dh, dc):
        if t.shape != h_prev.shape or t.device != h_prev.device \
                or t.dtype != h_prev.dtype:
            raise ValueError("dh and dc must match h_prev's shape, device "
                             "and dtype")
    if h_prev.device.type == "cpu":
        return cell_backward_dgates_ref(h_prev, x_pad, c_prev, s_term, wt,
                                        dh, dc, cx=cx, ch=ch)
    if h_prev.device.type != "cuda":
        raise ValueError(f"no kernel for device {h_prev.device}")
    _kernel_operands("cell backward",
                     (h_prev, x_pad, c_prev, s_term, wt, dh, dc),
                     h_prev.dtype)
    b, h, _, w = h_prev.shape
    plan = cell_plan(b, h, w, ch, cx, h_prev.dtype, kind="backward")
    dg = torch.empty_like(s_term)
    dc_prev = torch.empty_like(h_prev)
    ws = workspace(plan, b, h, w, ch, h_prev.device)
    with torch.cuda.device(h_prev.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().rsis_cell_bwd(
            h_prev.data_ptr(), None if x_pad is None else x_pad.data_ptr(),
            c_prev.data_ptr(), s_term.data_ptr(), wt.data_ptr(),
            dh.data_ptr(), dc.data_ptr(), dg.data_ptr(), dc_prev.data_ptr(),
            None if ws is None else ws.data_ptr(),
            0 if ws is None else ws.numel(), b, h, w, ch, cx,
            _DTYPE_CODES[h_prev.dtype], *plan_args(plan), stream)
    if err != 0:
        raise RuntimeError(f"cell backward kernel launch failed: CUDA error "
                           f"{err}")
    cell_backward_dgates.launches += 1
    return dg, dc_prev


cell_backward_dgates.launches = 0


# ---- K5: weight gradient --------------------------------------------------

def weight_grad_ref(h_prev, x_pad, dg, *, cx: int, ch: int) -> torch.Tensor:
    """Plain version of K5: dwt (4C, 9(Cx+C)) = sum over pixels of dg times
    the 9 shifted inputs (x taps, then h taps), in fp32, cast to dg's
    dtype. The x_pad ring is read as given (it is zero wherever the
    decoder builds x_pad); the h halo is zero."""
    b, h, _, w = dg.shape
    dgf = dg.float()
    sources = []
    if cx:
        sources.append(x_pad.float())
    sources.append(F.pad(h_prev.float(), (1, 1, 0, 0, 1, 1)))
    blocks = [torch.einsum("bhgw,bhcw->gc", dgf,
                           src[:, dy:dy + h, :, dx:dx + w])
              for src in sources for dy in range(3) for dx in range(3)]
    return torch.cat(blocks, dim=1).to(dg.dtype)


# The card the tensor-core plan is sized for: an H100's SMs, the shared
# memory of one SM and what one block may take (csrc/weight_grad.cu checks
# the latter again).
SM_COUNT = 132
SMEM_PER_SM = 228 * 1024
SMEM_LIMIT = 227 * 1024


# The FMA loop's thread tile (the kernel's kTm x kTc): 8 gate rows x 2
# channels x 9 taps, 144 accumulators, so one block of FMA_THREADS an SM.
FMA_TILE_M, FMA_TILE_C = 8, 2
FMA_THREADS = 256


@dataclasses.dataclass(frozen=True)
class WeightGradPlan:
    """How ``csrc/weight_grad.cu`` cuts one weight gradient.

    Either way units of ``rows`` output rows x ``tw`` columns, a ring of
    ``stages`` units, and ``chunks`` pixel chunks that each write an fp32
    partial of the whole (4C, 9(Cx+C)) gradient, summed in chunk order.
    mma: the tensor-core loop (bf16, C, Cx and W multiples of 8) with warp
    tiles of 16 wa gate rows x 8 wc channels x 9 taps, warps_m x warps_c
    warps a block. Otherwise the FMA loop: thread tiles of FMA_TILE_M gate
    rows x FMA_TILE_C channels x 9 taps, threads_m x threads_c threads a
    pixel group and ``groups`` groups a block."""
    mma: bool
    chunks: int
    wa: int = 0
    wc: int = 0
    warps_m: int = 0
    warps_c: int = 0
    rows: int = 0
    tw: int = 0
    stages: int = 0
    threads_m: int = 0
    threads_c: int = 0
    groups: int = 0

    @property
    def block_m(self) -> int:
        if not self.mma:
            return FMA_TILE_M * self.threads_m
        return 16 * self.wa * self.warps_m

    @property
    def block_c(self) -> int:
        if not self.mma:
            return FMA_TILE_C * self.threads_c
        return 8 * self.wc * self.warps_c

    @property
    def threads(self) -> int:
        if not self.mma:
            return self.threads_m * self.threads_c * self.groups
        return 32 * self.warps_m * self.warps_c

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block. The tensor-core loop (the
        kernel's ``Smem``): the ring of raw halo and dg rows, the
        transposed halo and 16 bytes of trash. The FMA loop
        (``FmaSmem``): the ring of fp32 dg rows and halos, or the pixel
        groups' tiles at the end where they take more."""
        mb, cb = self.block_m, self.block_c
        if not self.mma:
            *_, stage, reduce = self.fma_layout()
            return 4 * max(self.stages * stage, reduce)
        rs, ds, twp = self.tw + 24, self.tw + 8, self.tw + 2
        cs = cb + (0 if (cb // 8) % 2 else 8)
        ring = self.stages * ((self.rows + 2) * cb * rs
                              + self.rows * self.block_m * ds)
        return 2 * (ring + (self.rows + 2) * twp * cs + 8)

    def fma_layout(self) -> tuple:
        """The FMA loop's shared memory (the kernel's ``FmaSmem``), in
        floats: the dg row, halo row and halo channel strides, a slot's dg
        rows, a ring slot, and the pixel groups' tiles that reuse the ring
        at the end. ds / 4 and cs / 4 are odd, so float4 reads of 8
        neighbouring gate rows or channels at one pixel hit 8 different
        groups of 4 banks."""
        ds = self.tw if self.tw // 4 % 2 else self.tw + 4
        hs = self.tw + 4   # padded columns 0 .. tw + 1, read to tw + 3
        cs = (self.rows + 2) * hs
        cs += 0 if cs // 4 % 2 else 4
        dgn = self.rows * self.block_m * ds
        return (ds, hs, cs, dgn, dgn + self.block_c * cs,
                (self.groups - 1) * self.block_m * self.block_c * 9)

    def tiles(self, ch: int, cx: int) -> int:
        return (-(-4 * ch // self.block_m)) * (-(-(cx + ch) // self.block_c))

    def workspace_floats(self, ch: int, cx: int) -> int:
        return self.chunks * 4 * ch * 9 * (cx + ch)

    def units(self, b: int, h: int, w: int) -> int:
        """Units of work of a launch."""
        return b * -(-h // self.rows) * -(-w // self.tw)


def _pow2(n: int) -> int:
    """The least power of two at or above n >= 1."""
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _fma_plan(b: int, h: int, w: int, ch: int, cx: int,
              dtype: torch.dtype) -> WeightGradPlan:
    m, cn = 4 * ch, cx + ch
    thm = min(16, _pow2(-(-m // FMA_TILE_M)))
    thc = min((16, 8, 4, 2, 1), key=lambda t: -(-cn // (FMA_TILE_C * t)) * t)
    groups = FMA_THREADS // (thm * thc)
    rows = min(8, h)
    px = max(64, 32 * groups) // (1 if dtype == torch.float32 else 2)
    tw = min(128, _pow2(max(4, w)), _pow2(-(-px // rows)))
    plan = WeightGradPlan(False, 1, rows=rows, tw=tw, stages=3,
                          threads_m=thm, threads_c=thc, groups=groups)
    chunks = max(1, SM_COUNT // plan.tiles(ch, cx))
    while ((dataclasses.replace(plan, stages=2).smem_bytes() > SMEM_LIMIT
            or plan.units(b, h, w) < chunks)
           and (plan.tw > 4 or plan.rows > 1)):
        plan = (dataclasses.replace(plan, tw=plan.tw // 2) if plan.tw > 4
                else dataclasses.replace(plan, rows=plan.rows // 2))
    if plan.smem_bytes() > SMEM_LIMIT:
        plan = dataclasses.replace(plan, stages=2)
    return dataclasses.replace(plan,
                               chunks=min(plan.units(b, h, w), chunks))


def weight_grad_plan(b: int, h: int, w: int, ch: int, cx: int,
                     dtype: torch.dtype) -> WeightGradPlan:
    """The launch plan of K5 for dg (b, h, 4ch, w) and cx x channels.

    Tensor cores (bf16, ch, cx and w multiples of 8):
      - the block tile of at most 8 warps that divides (4ch, cx + ch) with
        the most gate rows x channels (each staged byte feeds more
        products), then the most warps, then gate rows nearest 4x the
        channels (fewer channels to transpose per product);
      - blocks per SM: one with the 32 x 16 warp tile (its 144
        accumulators take the registers), else two; the shared memory of
        a block is that share of the SM's;
      - the unit (rows x tw pixels) with the most useful pixels, up to
        256, whose 2-unit ring fits, then the fewest bytes staged per
        pixel (halo rows, the 8-column edges of h's rows, padding past the
        image), then the widest; a 3-unit ring where it fits;
      - chunks that balance a block's products against the write and read
        of its fp32 partial (sqrt(operations per tile / partial bytes)),
        at most one wave of blocks and one unit per chunk.
    FMA (everything else), one block of FMA_THREADS an SM:
      - threads_m: the fewest thread rows, up to 16, whose tiles cover
        4ch; threads_c: the power of two up to 16 that pads cx + ch the
        least (then the larger); the rest of the threads are pixel groups;
      - units of 8 rows (or h) x tw: 8 quads a pixel group and at least
        64 pixels in fp32, half that in bf16 (staged synchronously, it
        runs faster on units half the size), no wider than the image's
        power of two nor 128, halved (columns down to 4, then rows) until
        a ring of 2 fits and the launch has a unit for each chunk; the
        deepest ring (3, else 2 units) that fits;
      - chunks for one wave of blocks, at most one unit each.
    Timed on the card against the plans around it (chip_k5_step.py
    --fma-sweep): within 2.7% of the fastest at each of the Pascal
    recipe's cells (fp32) and the CVPPP recipe's edge cells (bf16,
    B=256)."""
    m, cn = 4 * ch, cx + ch
    if not (dtype == torch.bfloat16 and ch % 8 == 0 and cx % 8 == 0
            and w % 8 == 0):
        return _fma_plan(b, h, w, ch, cx, dtype)
    best = None
    for wa in (1, 2):
        for wc in (1, 2):
            for wm in range(1, 9):
                for wcn in range(1, 8 // wm + 1):
                    mb, cb = 16 * wa * wm, 8 * wc * wcn
                    if m % mb or cn % cb:
                        continue
                    key = (mb * cb, wm * wcn, -abs(math.log2(mb / (4 * cb))),
                           wa * wc)
                    if best is None or key > best[0]:
                        best = (key, (wa, wc, wm, wcn))
    wa, wc, wm, wcn = best[1]
    mb, cb = 16 * wa * wm, 8 * wc * wcn
    per_sm = 1 if wa * wc == 4 else 2
    budget = min(SMEM_LIMIT, SMEM_PER_SM // per_sm - 1024)
    w16 = -(-w // 16) * 16
    unit = None
    for rows in (8, 4, 2, 1):
        for tw in (128, 64, 32, 16):
            if tw > w16 or (rows > h and rows > 1):
                continue
            plan = WeightGradPlan(True, 1, wa, wc, wm, wcn, rows, tw, 2)
            if plan.smem_bytes() > budget:
                continue
            pad = (-(-h // rows) * rows / h) * (-(-w // tw) * tw / w)
            staged = (rows + 2) / rows * (tw + 16) / tw * pad
            key = (min(rows * tw, 256) / pad, -staged, tw)
            if unit is None or key > unit[0]:
                unit = (key, plan)
    if unit is None:
        raise ValueError(f"no K5 unit fits {budget} bytes of shared memory "
                         f"at C={ch}, Cx={cx}")
    plan = unit[1]
    if dataclasses.replace(plan, stages=3).smem_bytes() <= budget:
        plan = dataclasses.replace(plan, stages=3)
    tiles = (m // mb) * (cn // cb)
    tile_ops = 2.0 * m * 9 * cn * b * h * w / tiles
    partial_bytes = 2 * 4 * m * 9 * cn
    chunks = min(round(math.sqrt(tile_ops / partial_bytes)),
                 per_sm * SM_COUNT // tiles, plan.units(b, h, w))
    return dataclasses.replace(plan, chunks=max(1, chunks))


@functools.lru_cache(maxsize=None)
def _dwt_lib() -> ctypes.CDLL:
    lib = _build.load("weight_grad")
    lib.rsis_weight_grad.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 18 + [ctypes.c_void_p])
    lib.rsis_weight_grad.restype = ctypes.c_int
    return lib


def weight_grad_rowmajor(h_prev, x_pad, dg, *, cx: int,
                         ch: int) -> torch.Tensor:
    """Weight gradient of the packed gate weight: dwt (4C, 9(Cx+C)) in dg's
    dtype (summed in fp32).

    CPU tensors take the plain version. CUDA tensors (float32 or bfloat16,
    contiguous, 16-byte aligned) launch ``csrc/weight_grad.cu`` as
    ``weight_grad_plan`` cuts it (two passes: chunk partials, then their
    sum in a fixed order, so the result is the same on every run) and
    count one launch in ``weight_grad_rowmajor.launches``, and in
    ``weight_grad_rowmajor.fma_launches`` where the plan takes the FMA
    loop."""
    b, h, c_dim, w = h_prev.shape
    if c_dim != ch or tuple(dg.shape) != (b, h, 4 * ch, w):
        raise ValueError(f"h_prev {tuple(h_prev.shape)} / dg "
                         f"{tuple(dg.shape)} do not hold C={ch}")
    if (cx == 0) != (x_pad is None) or (
            cx and tuple(x_pad.shape) != (b, h + 2, cx, w + 2)):
        raise ValueError(f"x_pad must be {(b, h + 2, cx, w + 2)} when cx > 0"
                         f" and None when cx == 0")
    tensors = [t for t in (h_prev, x_pad, dg) if t is not None]
    if any(t.device != dg.device or t.dtype != dg.dtype for t in tensors):
        raise ValueError("all operands must share one device and dtype")
    if dg.device.type == "cpu":
        return weight_grad_ref(h_prev, x_pad, dg, cx=cx, ch=ch)
    if dg.device.type != "cuda":
        raise ValueError(f"no kernel for device {dg.device}")
    _kernel_operands("weight gradient", tensors, dg.dtype)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("weight gradient kernel needs 16-byte aligned "
                         "operands")
    plan = weight_grad_plan(b, h, w, ch, cx, dg.dtype)
    lib = _dwt_lib()
    n_ws = plan.workspace_floats(ch, cx)
    ws = torch.empty(n_ws, dtype=torch.float32, device=dg.device)
    dwt = torch.empty((4 * ch, 9 * (cx + ch)), dtype=dg.dtype,
                      device=dg.device)
    with torch.cuda.device(dg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rsis_weight_grad(
            h_prev.data_ptr(), None if x_pad is None else x_pad.data_ptr(),
            dg.data_ptr(), ws.data_ptr(), n_ws, dwt.data_ptr(), b, h, w, ch,
            cx, _DTYPE_CODES[dg.dtype], int(plan.mma), plan.wa, plan.wc,
            plan.warps_m, plan.warps_c, plan.rows, plan.tw, plan.stages,
            plan.chunks, plan.threads_m, plan.threads_c, plan.groups,
            stream)
    if err != 0:
        raise RuntimeError(f"weight gradient kernel launch failed: CUDA "
                           f"error {err}")
    weight_grad_rowmajor.launches += 1
    weight_grad_rowmajor.fma_launches += not plan.mma
    return dwt


weight_grad_rowmajor.launches = 0
weight_grad_rowmajor.fma_launches = 0


# ---- the pullback conv's weight and the whole backward ------------------

def conv_transpose_weights(wt: torch.Tensor, cx: int, ch: int,
                           take: str) -> torch.Tensor:
    """Packed (Cout', 9 * 4C) weight of the transposed gate convolution for
    the input part selected by ``take`` ("x", "h" or "xh", x rows first):
    row c, tap t holds wt[:, src + c] of the spatially flipped tap
    8 - t (``_conv_transpose_rowmajor``'s repack)."""
    g4 = 4 * ch
    parts = []
    if take in ("x", "xh"):
        parts.append(wt[:, :9 * cx].reshape(g4, 9, cx))
    if take in ("h", "xh"):
        parts.append(wt[:, 9 * cx:].reshape(g4, 9, ch))
    w = torch.cat(parts, dim=2).flip(1)                  # (4C, 9, Cout')
    return w.permute(2, 1, 0).reshape(-1, 9 * g4).contiguous()


def cell_bwd_core(h_prev, x_pad, c_prev, s_term, wt, dh, dc, *, cx: int,
                  ch: int):
    """Backward body of the cell: (dg, dc_prev, dwt, dx_pad, dh_prev),
    dx_pad the up-input cotangent with a zero ring (B, H+2, Cx, W+2), or
    None when cx == 0.

    The ring of x_pad reaches the edge gates, but its cotangent is dropped:
    the decoder builds x_pad with a structurally zero ring (the padded
    interpolation matrices), whose transpose drops those gradients anyway,
    so the composed gradient is exact."""
    dg, dc_prev = cell_backward_dgates(h_prev, x_pad, c_prev, s_term, wt, dh,
                                       dc, cx=cx, ch=ch)
    dwt = weight_grad_rowmajor(h_prev, x_pad, dg, cx=cx, ch=ch)
    # one launch writes both pullbacks (x rows first): dx_pad with its
    # zero ring and dh_prev, no slice or pad after it
    wpack = conv_transpose_weights(wt, cx, ch, "xh" if cx else "h")
    dx_pad, dh_prev = conv3x3_pullback(dg, wpack, cx=cx, ch=ch)
    return dg, dc_prev, dwt, dx_pad, dh_prev


class FusedCellFunction(torch.autograd.Function):
    """Differentiable fused cell: apply(h_prev, x_pad, c_prev, s_term, wt,
    cx, ch) -> (h, c). The forward is K1; the backward keeps the forward's
    inputs and runs K4, K5 and K3. It returns (dh_prev, dx_pad, dc_prev,
    ds = dg, dwt), dx_pad being dx with a zero ring."""

    @staticmethod
    def forward(ctx, h_prev, x_pad, c_prev, s_term, wt, cx: int, ch: int):
        ctx.save_for_backward(h_prev, x_pad, c_prev, s_term, wt)
        ctx.cx, ctx.ch = cx, ch
        return fused_cell_rowmajor(h_prev, x_pad, c_prev, s_term, wt, cx=cx,
                                   ch=ch)

    @staticmethod
    def backward(ctx, dh, dc):
        with span("rsis.backward.cell"):
            h_prev, x_pad, c_prev, s_term, wt = ctx.saved_tensors
            # autograd may hand over strided cotangents; the kernels take
            # contiguous ones
            dg, dc_prev, dwt, dx_pad, dh_prev = cell_bwd_core(
                h_prev, x_pad, c_prev, s_term, wt, dh.contiguous(),
                dc.contiguous(), cx=ctx.cx, ch=ctx.ch)
            return dh_prev, dx_pad, dc_prev, dg, dwt, None, None
