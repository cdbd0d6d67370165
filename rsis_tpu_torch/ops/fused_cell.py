"""Fused ConvLSTM decode cell in the (B, H, C, W) layout.

Counterpart of ``rsis_tpu/ops/pallas_decode.py``: ``pack_cell_weights``
and ``fused_cell_rowmajor`` (the Pallas ``_cell_kernel`` /
``_cell_kernel_dyfold``). One cell step is

  gates = conv3x3_same([x_pad || h_prev], W) + S
  c = sig(f) * c_prev + sig(i) * tanh(g);   h = sig(o) * tanh(c)

with gate order i, f, o, g, the gate sum and the update in fp32, and h, c
stored in the input dtype. On a CUDA tensor ``fused_cell_rowmajor``
launches the hand-written kernel ``csrc/fused_cell.cu`` as ``cell_plan``
cuts it; on a CPU tensor it runs ``fused_cell_rowmajor_ref``, the plain
PyTorch version of the same arithmetic. ``cell_plan`` also cuts the cell
backward's kernel (``csrc/cell_bwd.cu``) and the NCHW ConvLSTM step's
(``csrc/clstm_step.cu``), which share the main loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The card the tensor-core plan is sized for: an H100's SMs and the shared
# memory one block may take (the kernels check the latter again).
SM_COUNT = 132
SMEM_LIMIT = 227 * 1024
SMEM_PER_SM = 228 * 1024


def _unit_shape(pixels: int, h: int, w: int) -> tuple[int, int]:
    """(rows, tw) of a unit of ``pixels``: tw a power of two from 16 up to
    W rounded up to 16; the fewest input bytes staged per useful output
    pixel (halo rows and the 8-column edges, padding past the image), then
    the widest."""
    best = None
    tw = 16
    while tw <= min(pixels, -(-w // 16) * 16):
        rows = pixels // tw
        pad = (-(-h // rows) * rows / h) * (-(-w // tw) * tw / w)
        staged = (rows + 2) / rows * (tw + 16) / tw * pad
        if best is None or (staged, -tw) < best[0]:
            best = ((staged, -tw), (rows, tw))
        tw *= 2
    return best[1]


def _divisor_at_most(n: int, cap: int) -> int:
    return max(d for d in range(1, n + 1) if n % d == 0 and d <= max(cap, 1))


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


# The staged loop's instantiations (csrc/cell_common.cuh): m-tiles of 16
# pixels a warp, blocks of 8 hidden channels (4 n-tiles, the gates) a
# warp, at most 128 fp32 accumulators a thread; K-chunk widths (8, where C
# or Cx is an odd multiple of 8: two taps a k16 step of mma).
CELL_WARP_M = (4, 2, 1)
CELL_WARP_J = (4, 2, 1)
CELL_CHUNKS = (64, 32, 16, 8)
MAX_WARP_TILES = 8          # wm * wj: 16 wm wj accumulators a thread
# The kernels on the staged loop, by the epilogue's planes a block stages
# (max(kIn, kOut) of the kernel's epilogue): K1 "forward" (S's four gates
# and c_prev in, h and c out), K4 "backward" (and dh, dc in; dg's gates
# and dc_prev out), K8 "step" (c_prev in, h and c out; its fp32 gate bias
# beside them)
EPI_PLANES = {"forward": 5, "backward": 7, "step": 2}


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """How ``csrc/fused_cell.cu`` (K1), ``csrc/cell_bwd.cu`` (K4) and
    ``csrc/clstm_step.cu`` (K8) cut one cell.

    mma: the staged tensor-core loop (bf16, C and Cx multiples of 8; W a
    multiple of 8 too, or for K1 the kernel's edge variant, which stages
    every row from its 16-byte boundary at the row's phase) with warp
    tiles of wm m-tiles (16 pixels of one row) x wj blocks of 8 hidden
    channels (each with its four gates), warps_m x warps_n warps a
    block, units of ``rows`` x ``tw`` output pixels (rows * tw == 16 wm
    warps_m) and a tile of ``block_c`` = 8 wj warps_n hidden channels,
    K-chunks of all nine taps x ``cc`` channels of x or of h in a ring of
    ``stages``, the chunks cut into ``splits`` parts (each writes fp32
    partial gate sums, summed in part order by a second launch that runs
    the epilogue) and the units dealt in order to ``groups`` blocks per
    (channel tile, part), ``per_sm`` blocks an SM (2 only with wm * wj <=
    4, the kernel then built for 128 registers a thread); otherwise the
    FMA loop."""
    mma: bool
    wm: int = 0
    wj: int = 0
    warps_m: int = 0
    warps_n: int = 0
    rows: int = 0
    tw: int = 0
    cc: int = 0
    stages: int = 0
    splits: int = 1
    groups: int = 0
    per_sm: int = 1

    @property
    def block_c(self) -> int:
        return 8 * self.wj * self.warps_n

    @property
    def pixels(self) -> int:
        return self.rows * self.tw

    def units(self, b: int, h: int, w: int) -> int:
        return b * -(-h // self.rows) * -(-w // self.tw)

    def blocks(self, ch: int) -> int:
        return ch // self.block_c * self.splits * self.groups

    def chunks(self, ch: int, cx: int) -> int:
        return (cx + ch) // self.cc

    def smem_bytes(self, ch: int, cx: int, kind: str = "forward", *,
                   w: int) -> int:
        """Dynamic shared memory of one block (the kernel's ``CellSmem``)
        at images w wide: the ring of raw input rows, the weight slots (one
        when a block has one chunk), the transposed halo, the epilogue's
        planes (``EPI_PLANES[kind]``; none with parts; where w is not a
        multiple of 8, the edge variant's row of tw + 8 elements for each
        of the unit's rows), 16 bytes of trash, the planes' mbarrier and,
        for K8, the tile's fp32 gate biases."""
        ks = 9 * self.cc + (16 if (9 * self.cc // 8) % 2 else 8)
        cs = self.cc + (0 if (self.cc // 8) % 2 else 8)
        raw = (self.rows + 2) * self.cc * (self.tw + 24)
        wgt = 4 * self.block_c * ks
        wslots = 1 if self.chunks(ch, cx) // self.splits == 1 else \
            self.stages
        halo = (self.rows + 2) * (self.tw + 2) * cs
        row = self.rows * (self.tw + 8) if w % 8 else self.pixels
        epi = 0 if self.splits > 1 else EPI_PLANES[kind] * self.block_c * (
            row + 8)
        bias = 4 * 4 * self.block_c if kind == "step" else 0
        return (2 * (self.stages * raw + wslots * wgt + halo + epi + 8) + 16
                + bias)

    def two_per_sm(self, ch: int, cx: int, kind: str = "forward", *,
                   w: int) -> bool:
        """Whether an SM can hold two blocks at once: the warp tile keeps
        at most 64 accumulators a thread (the kernel is then built for 128
        registers) and two blocks' shared memory fits."""
        return (self.wm * self.wj <= 4 and self.smem_bytes(
            ch, cx, kind, w=w) <= SMEM_PER_SM // 2 - 1024)

    def staged_bytes(self) -> int:
        """Bytes one chunk of one unit brings into shared memory (the
        halo rows' real columns and the weight slot), for 72 products of
        each pixel x channel x chunk channel."""
        return 2 * ((self.rows + 2) * self.cc * (self.tw + 16)
                    + 4 * self.block_c * 9 * self.cc)

    def workspace_floats(self, b: int, h: int, w: int, ch: int) -> int:
        return self.splits * b * h * 4 * ch * w if self.splits > 1 else 0


@functools.lru_cache(maxsize=None)
def cell_plan(b: int, h: int, w: int, ch: int, cx: int, dtype: torch.dtype,
              *, kind: str = "forward") -> CellPlan:
    """The launch plan of K1 (``kind`` "forward"), K4 ("backward") or K8
    ("step", the NCHW ConvLSTM step) for b images of h x w, ch hidden and
    cx x channels.

    Tensor cores (bf16, ch, cx and w multiples of 8; for K1 any w, the
    kernel's edge variant where w is not a multiple of 8), one block of 8
    warps an SM:
      - the K-chunk: the widest of 64, 32, 16 channels that divides ch and
        cx (8, two taps a k16 step, only where none does);
      - the block tile: the most pixels x hidden channels (at most 128
        accumulators a thread; a unit no larger than one image, rows x tw
        by ``_unit_shape``) whose 2-stage ring of the narrowest chunk and
        epilogue planes fit, then the fewest bytes staged per product
        (halo rows and weight slot over pixels x channels);
      - wm halved (down to 2) where units x channel tiles would leave
        half the SMs idle, and the chunk widened again where the smaller
        tile's ring allows;
      - a 3-stage ring where it fits (the edge variant's checked again
        after a split, whose parts stage no epilogue planes);
      - the split: where units x channel tiles leave SMs idle, the chunks
        are cut into the most parts (a divisor of the chunk count) that
        keep the blocks within one wave, one unit a block; otherwise one
        part and the units dealt to one wave of blocks (two blocks an SM
        where ``two_per_sm`` allows).
    FMA otherwise (fp32, other channel widths; K4 and K8 at a w that is
    not a multiple of 8): the kernel's own FMA launch. Cached: the search
    runs once per shape, not once per launch."""
    if not (dtype == torch.bfloat16 and ch % 8 == 0 and cx % 8 == 0
            and (kind == "forward" or w % 8 == 0)):
        return CellPlan(mma=False)
    ccs = [c for c in CELL_CHUNKS if ch % c == 0 and cx % c == 0]
    ccs = [c for c in ccs if c >= 16] or ccs
    image = h * -(-w // 16) * 16
    best = None
    for wm in CELL_WARP_M:
        for wj in CELL_WARP_J:
            for warps_n in (1, 2, 4, 8):
                warps_m = 8 // warps_n
                ct, px = 8 * wj * warps_n, 16 * wm * warps_m
                if (ch % ct or wm * wj > MAX_WARP_TILES
                        or px > max(image, 16 * warps_m)):
                    continue
                cc = ccs[-1]   # the narrowest chunk: the tile must fit
                if cc == 8 and wj > 2:
                    continue
                plan = CellPlan(True, wm, wj, warps_m, warps_n,
                                *_unit_shape(px, h, w), cc, 2, 1, 1)
                if plan.smem_bytes(ch, cx, kind, w=w) > SMEM_LIMIT:
                    continue
                key = (px * ct, -plan.staged_bytes() / (px * ct * cc), wm)
                if best is None or key > best[0]:
                    best = (key, plan)
    if best is None:
        raise ValueError(f"no cell tile fits {SMEM_LIMIT} bytes of shared "
                         f"memory at C={ch}, Cx={cx}")
    plan = best[1]
    n_ct = ch // plan.block_c
    while plan.wm > 2 and 2 * plan.units(b, h, w) * n_ct <= SM_COUNT:
        wm = plan.wm // 2
        rows, tw = _unit_shape(16 * wm * plan.warps_m, h, w)
        plan = dataclasses.replace(plan, wm=wm, rows=rows, tw=tw)
    # the widest chunk whose 2-stage ring fits the tile, then a third
    # stage where it fits
    plan = next(p for p in (dataclasses.replace(plan, cc=cc) for cc in ccs
                            if cc != 8 or plan.wj <= 2)
                if p.smem_bytes(ch, cx, kind, w=w) <= SMEM_LIMIT)
    three = dataclasses.replace(plan, stages=3)
    if three.smem_bytes(ch, cx, kind, w=w) <= SMEM_LIMIT:
        plan = three
    n_units = plan.units(b, h, w)
    if n_units * n_ct < SM_COUNT:
        splits = _divisor_at_most(plan.chunks(ch, cx),
                                  SM_COUNT // (n_units * n_ct))
        plan = dataclasses.replace(plan, splits=splits, groups=n_units)
        # parts stage no epilogue planes, so a third stage may fit now;
        # only the edge variant takes it (the aligned loop keeps the ring
        # chosen before the split)
        three = dataclasses.replace(plan, stages=3)
        return (three if w % 8 and splits > 1 and three.smem_bytes(
            ch, cx, kind, w=w) <= SMEM_LIMIT else plan)
    per_sm = 2 if plan.two_per_sm(ch, cx, kind, w=w) else 1
    return dataclasses.replace(plan, per_sm=per_sm, groups=min(
        n_units, max(1, per_sm * SM_COUNT // n_ct)))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_cell")
    lib.rsis_fused_cell.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 18
        + [ctypes.c_void_p])
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
    contiguous) launch ``csrc/fused_cell.cu`` as ``cell_plan`` cuts it
    and count one launch in ``fused_cell_rowmajor.launches``, and one in
    ``fused_cell_rowmajor.mma_launches`` where the plan takes the tensor
    cores."""
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
    plan = cell_plan(b, h, w, ch, cx, h_prev.dtype)
    h_out = torch.empty_like(h_prev)
    c_out = torch.empty_like(h_prev)
    ws = workspace(plan, b, h, w, ch, h_prev.device)
    with torch.cuda.device(h_prev.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rsis_fused_cell(
            h_prev.data_ptr(), None if x_pad is None else x_pad.data_ptr(),
            c_prev.data_ptr(), s_term.data_ptr(), wt.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            0 if ws is None else ws.numel(), b, h, w, ch, cx,
            _DTYPE_CODES[h_prev.dtype], *plan_args(plan), stream)
    if err != 0:
        raise RuntimeError(f"fused cell kernel launch failed: CUDA error "
                           f"{err}")
    fused_cell_rowmajor.launches += 1
    fused_cell_rowmajor.mma_launches += plan.mma
    return h_out, c_out


fused_cell_rowmajor.launches = 0
fused_cell_rowmajor.mma_launches = 0


def plan_args(plan: CellPlan) -> tuple:
    """The plan as the kernels' C interface takes it."""
    return (int(plan.mma), plan.wm, plan.wj, plan.warps_m, plan.warps_n,
            plan.rows, plan.tw, plan.cc, plan.stages, plan.splits,
            plan.groups, plan.per_sm)


def workspace(plan: CellPlan, b: int, h: int, w: int, ch: int,
              device: torch.device) -> torch.Tensor | None:
    """The parts' fp32 partial gate sums, or None with one part."""
    n = plan.workspace_floats(b, h, w, ch)
    return torch.empty(n, dtype=torch.float32, device=device) if n else None
