"""The host-side plan of K5, the weight gradient
(``ops/fused_cell_vjp.weight_grad_plan``), and the layout of
``csrc/weight_grad.cu``'s tensor-core loop that it sizes.

No card here: the plan is checked for what the kernel takes (tiles that
divide the cell, a ring that fits the shared memory, one block per SM, a
workspace of one fp32 partial per chunk), and a numpy mirror of the
kernel's staging (dg rows; x_pad rows from the 16-byte boundary before
the unit, at their phase; h rows with their 8-column edges), its
[channel][pixel] -> [pixel][channel] transposition and its
shifted-tap products is held against the plain version at shapes whose
H and W are not multiples of the unit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rsis_tpu_torch.ops import fused_cell_vjp as fcv
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# (H, W, C, Cx) of the train step's five cells (256x512, hidden 128)
TRAIN_CELLS = [(8, 16, 128, 0), (16, 32, 64, 128), (32, 64, 32, 64),
               (64, 128, 16, 32), (128, 256, 8, 16)]


def _check_mma_plan(b, h, w, c, cx):
    plan = fcv.weight_grad_plan(b, h, w, c, cx, torch.bfloat16)
    m, cn = 4 * c, cx + c
    assert plan.mma and plan.wa in (1, 2) and plan.wc in (1, 2)
    assert plan.warps_m * plan.warps_c <= 8
    assert m % plan.block_m == 0 and cn % plan.block_c == 0
    assert plan.tw % 16 == 0 and plan.tw <= -(-w // 16) * 16
    assert 1 <= plan.rows <= max(h, 1) and plan.stages in (2, 3)
    # one block an SM with the 32 x 16 warp tile, else two
    per_sm = 1 if plan.wa * plan.wc == 4 else 2
    assert plan.smem_bytes() <= min(fcv.SMEM_LIMIT,
                                    fcv.SMEM_PER_SM // per_sm - 1024)
    if plan.stages == 2:   # a third unit would not fit
        assert fcv.dataclasses.replace(plan, stages=3).smem_bytes() > min(
            fcv.SMEM_LIMIT, fcv.SMEM_PER_SM // per_sm - 1024)
    tiles = (m // plan.block_m) * (cn // plan.block_c)
    assert 1 <= plan.chunks <= max(1, per_sm * fcv.SM_COUNT // tiles)
    assert plan.chunks <= plan.units(b, h, w)
    assert plan.workspace_floats(c, cx) == plan.chunks * m * 9 * cn
    return plan


@pytest.mark.parametrize("b", [32, 8])
@pytest.mark.parametrize("cell", range(5))
def test_train_cells_take_the_tensor_cores(b, cell):
    h, w, c, cx = TRAIN_CELLS[cell]
    plan = _check_mma_plan(b, h, w, c, cx)
    # a full wave of blocks where the cell has the work for it
    if b == 32 and cell:
        per_sm = 1 if plan.wa * plan.wc == 4 else 2
        tiles = (4 * c // plan.block_m) * ((cx + c) // plan.block_c)
        assert tiles * plan.chunks == per_sm * fcv.SM_COUNT


def test_bench_geometry_tiles():
    """The plans the source note describes at B=32: 128 x 32 tiles of
    eight 32 x 16 warps at cells 0-2, 64 x 48 (six warps) at cell 3 and
    the whole 32 x 24 gradient (six warps of 16 x 8, two blocks an SM) at
    cell 4; units of 128 pixels at cells 0-2 and 256 at cells 3-4."""
    got = [fcv.weight_grad_plan(32, *g, torch.bfloat16) for g in
           TRAIN_CELLS]
    assert [(p.block_m, p.block_c) for p in got] == [
        (128, 32), (128, 32), (128, 32), (64, 48), (32, 24)]
    assert [(p.wa, p.wc) for p in got] == [(2, 2)] * 4 + [(1, 1)]
    assert [(p.rows, p.tw, p.stages) for p in got] == [
        (8, 16, 2), (4, 32, 3), (4, 32, 3), (4, 64, 2), (4, 64, 2)]
    assert [p.chunks for p in got] == [8, 11, 44, 132, 264]


def test_edge_shapes_cover_every_warp_tile():
    plans = [_check_mma_plan(b, *g) for g, b in chip_smoke.K5_EDGE_GEOMS]
    assert {(p.wa, p.wc) for p in plans} == {(1, 1), (1, 2), (2, 1),
                                              (2, 2)}
    shapes = [g for g, _ in chip_smoke.K5_EDGE_GEOMS]
    assert any(h % p.rows for (h, *_), p in zip(shapes, plans))
    assert any(w % p.tw for (_, w, *_), p in zip(shapes, plans))
    assert any(w < p.tw for (_, w, *_), p in zip(shapes, plans))
    assert any(cx == 0 for *_, cx in shapes)
    assert any(b == 1 for _, b in chip_smoke.K5_EDGE_GEOMS)
    assert any(c == 8 for _, _, c, _ in shapes)


@pytest.mark.parametrize("args", [
    (2, 32, 64, 4, 12, torch.bfloat16),    # widths not multiples of 8
    (32, 128, 256, 8, 16, torch.float32),  # fp32
    (2, 8, 20, 8, 8, torch.bfloat16),      # W not a multiple of 8
])
def test_fma_plan(args):
    b, h, w, c, cx, dtype = args
    plan = fcv.weight_grad_plan(*args)
    assert not plan.mma
    tiles = -(-4 * c // 16) * -(-9 * (cx + c) // 16)
    assert plan.chunks == max(1, min(-(-2 * fcv.SM_COUNT // tiles),
                                     -(-b * h * w // 256)))


def _mirror(h_prev, x_pad, dg, cx, plan):
    """csrc/weight_grad.cu's tensor-core loop in numpy, unit by unit:
    returns (dwt, how many times each (chunk, pixel) product was taken)."""
    b_, hh, c, ww = h_prev.shape
    m, cn = 4 * c, cx + c
    mb, cb, rows, tw = plan.block_m, plan.block_c, plan.rows, plan.tw
    rs = tw + 24
    n_mt, n_ct = m // mb, cn // cb
    n_xt, n_rg = -(-ww // tw), -(-hh // rows)
    n_units = b_ * n_rg * n_xt
    out = np.zeros((m, 9 * cn))
    x_flat = x_pad.reshape(-1) if cx else None
    seen = np.zeros((b_, hh, ww), int)
    for blk in range(n_mt * n_ct * plan.chunks):
        m0, c0 = blk % n_mt * mb, blk // n_mt % n_ct * cb
        chunk = blk // (n_mt * n_ct)
        cxb = max(0, min(cb, cx - c0))
        ch0 = max(c0, cx) - cx
        for u in range(n_units * chunk // plan.chunks,
                       n_units * (chunk + 1) // plan.chunks):
            x0, y0 = u % n_xt * tw, u // n_xt % n_rg * rows
            b = u // (n_xt * n_rg)
            dgs = np.zeros((rows, mb, tw))
            raw = np.full((rows + 2, cb, rs), np.nan)
            for r in range(rows):
                for q in range(tw // 8):
                    y, x = y0 + r, x0 + 8 * q
                    if y < hh and x < ww:
                        dgs[r, :, 8 * q:8 * q + 8] = dg[b, y, m0:m0 + mb,
                                                        x:x + 8]
            phase = np.zeros((rows + 2, cb), int)
            for r in range(rows + 2):
                for k in range(cxb):     # x_pad rows from 16-byte bounds
                    start = (((b * (hh + 2) + y0 + r) * cx + c0 + k)
                             * (ww + 2) + x0)
                    phase[r, k] = start % 8
                    for q in range(tw // 8 + 1):
                        e = start - phase[r, k] + 8 * q
                        part = (x_flat[e:e + 8] if y0 + r < hh + 2
                                else np.zeros(0))
                        raw[r, k, 8 * q:8 * q + 8] = 0
                        raw[r, k, 8 * q:8 * q + len(part)] = part
                for q in range(tw // 8 + 2):     # 16-byte copies of h
                    iy, ix = y0 + r - 1, x0 - 8 + 8 * q
                    ok = 0 <= iy < hh and 0 <= ix < ww
                    raw[r, cxb:, 8 * q:8 * q + 8] = (
                        h_prev[b, iy, ch0:ch0 + cb - cxb, ix:ix + 8]
                        if ok else 0)
            halo = np.full((rows + 2, tw + 2, cb), np.nan)
            for g in range(cb // 8):             # the 8x8 transposition
                for pc in range(tw + 2):
                    for k in range(8 * g, 8 * g + 8):
                        j = pc + 7 if k >= cxb else pc + phase[:, k]
                        halo[:, pc, k] = raw[np.arange(rows + 2), k, j]
            for r in range(min(rows, hh - y0)):
                for p0 in range(0, min(tw, ww - x0), 16):
                    if blk % (n_mt * n_ct) == 0:
                        y = y0 + r
                        seen[b, y, x0 + p0:min(x0 + p0 + 16, ww)] += 1
                    for t in range(9):
                        dy, dx = divmod(t, 3)
                        prod = dgs[r, :, p0:p0 + 16] @ halo[
                            r + dy, p0 + dx:p0 + dx + 16]
                        for cc in range(cb):
                            ch = c0 + cc
                            col = (t * cx + ch if ch < cx
                                   else 9 * cx + t * c + ch - cx)
                            out[m0:m0 + mb, col] += prod[:, cc]
    return out, seen


@pytest.mark.parametrize("geom,b", chip_smoke.K5_EDGE_GEOMS[:3])
def test_kernel_layout_mirror_matches_plain(geom, b):
    hh, ww, c, cx = geom
    rng = np.random.default_rng(0)
    h_prev = rng.normal(size=(b, hh, c, ww)).astype(np.float32)
    x_pad = (rng.normal(size=(b, hh + 2, cx, ww + 2)).astype(np.float32)
             if cx else None)
    dg = rng.normal(size=(b, hh, 4 * c, ww)).astype(np.float32)
    plan = fcv.weight_grad_plan(b, hh, ww, c, cx, torch.bfloat16)
    got, seen = _mirror(h_prev, x_pad, dg, cx, plan)
    want = fcv.weight_grad_ref(
        torch.from_numpy(h_prev),
        None if x_pad is None else torch.from_numpy(x_pad),
        torch.from_numpy(dg), cx=cx, ch=c).double().numpy()
    assert np.array_equal(seen, np.ones_like(seen))   # each pixel once
    # the plain version sums in fp32, the mirror in fp64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
