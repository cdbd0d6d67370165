"""The host-side plan of K5, the weight gradient
(``ops/fused_cell_vjp.weight_grad_plan``), and the layouts of
``csrc/weight_grad.cu``'s two loops that it sizes.

No card here: the plan is checked for what the kernel takes (tiles that
cover the cell, a ring that fits the shared memory, blocks that fill the
card, a workspace of one fp32 partial per chunk). Numpy mirrors of the
two loops are held against the plain version at shapes whose H and W are
not multiples of the unit: the tensor-core loop's staging (dg rows; x_pad
rows from the 16-byte boundary before the unit, at their phase; h rows
with their 8-column edges), its [channel][pixel] -> [pixel][channel]
transposition and its shifted-tap products; the FMA loop's staging into
its flat shared-memory ring (dg rows, the halo at its padded columns), its
taps as offsets into the halo, its register tiles over 4-pixel quads,
pixel groups and their sum in group order."""

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


# (B, H, W, C, Cx, dtype) of the FMA loop: the cases of its first design
# (widths not multiples of 8; the train step's finest cell in fp32; W not
# a multiple of 8), the Pascal recipe's five cells (256x256, B=28, fp32),
# the CVPPP recipe's four edge cells in bf16 (widths 13-100, B=2 and 256)
# and chip_smoke.K5_EDGE_GEOMS in fp32, and the narrowest cells
# (chip_smoke.K5_NARROW_GEOMS: C of 1 and 2) in both dtypes
PASCAL_CELLS = chip_smoke.concat_geoms(256, 256, (128, 64, 32, 16, 8))
LEAVES_CELLS = chip_smoke.concat_geoms(400, 400, (128, 64, 32, 16, 8))[:4]
FMA_CASES = ([(2, 32, 64, 4, 12, torch.bfloat16),
              (32, 128, 256, 8, 16, torch.float32),
              (2, 8, 20, 8, 8, torch.bfloat16)]
             + [(28, *g, torch.float32) for g in PASCAL_CELLS]
             + [(b, *g, torch.bfloat16) for b in (2, 256)
                for g in LEAVES_CELLS]
             + [(b, *g, torch.float32) for g, b in chip_smoke.K5_EDGE_GEOMS]
             + [(b, *g, dtype) for g, b in chip_smoke.K5_NARROW_GEOMS
                for dtype in (torch.float32, torch.bfloat16)])


@pytest.mark.parametrize("args", FMA_CASES)
def test_fma_plan(args):
    b, h, w, c, cx, dtype = args
    plan = fcv.weight_grad_plan(*args)
    m, cn = 4 * c, cx + c
    assert not plan.mma
    # the tiles cover (4C, 9(Cx+C)), no thread row or column wholly past it
    assert plan.block_m - fcv.FMA_TILE_M < m
    assert plan.block_c - fcv.FMA_TILE_C < cn
    assert plan.threads == fcv.FMA_THREADS
    assert plan.tw % 4 == 0 and plan.tw <= -(-w // 4) * 4
    assert 1 <= plan.rows <= max(h, 1) and plan.stages in (2, 3)
    # the ring fits the shared memory, a third unit where one does
    assert plan.smem_bytes() <= fcv.SMEM_LIMIT
    if plan.stages == 2:
        assert fcv.dataclasses.replace(
            plan, stages=3).smem_bytes() > fcv.SMEM_LIMIT
    # the blocks fill the card as far as whole chunks allow, unless every
    # unit is its own chunk
    tiles = plan.tiles(c, cx)
    assert 1 <= plan.chunks <= plan.units(b, h, w)
    assert tiles * plan.chunks <= max(tiles, fcv.SM_COUNT)
    assert (tiles * plan.chunks > fcv.SM_COUNT - tiles
            or plan.chunks == plan.units(b, h, w))
    assert plan.workspace_floats(c, cx) == plan.chunks * m * 9 * cn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_every_decoder_width_has_a_plan(hidden, dtype):
    """Every cell of a decoder of these hidden sizes, at the Pascal
    recipe's input and at 64x64, gets a launch plan whose ring fits."""
    from rsis_tpu_torch.models.decoder import decoder_widths
    for hw, b in (((256, 256), 28), ((64, 64), 1)):
        for h, w, c, cx in chip_smoke.concat_geoms(*hw,
                                                   decoder_widths(hidden)):
            plan = fcv.weight_grad_plan(b, h, w, c, cx, dtype)
            assert plan.smem_bytes() <= fcv.SMEM_LIMIT
            assert 1 <= plan.chunks <= plan.units(b, h, w)
            assert plan.tiles(c, cx) >= 1


def test_pascal_plans_fill_the_card_with_small_partials():
    """At the Pascal recipe's cells each launch runs at least 90% of an SM
    per SM, at most four waves, and its partials, written and read back,
    take at most half its operations' time at the memory's rate (cell 0,
    2.1 GFLOP over 1,792 pixels, reads 0.36: 8 chunks of a 2.4 MB
    gradient)."""
    for g in PASCAL_CELLS:
        plan = fcv.weight_grad_plan(28, *g, torch.float32)
        h, w, c, cx = g
        assert plan.tiles(c, cx) * plan.chunks >= 0.9 * fcv.SM_COUNT
        assert plan.tiles(c, cx) * plan.chunks <= 4 * fcv.SM_COUNT
        ops_s = 2.0 * 4 * c * 9 * (cx + c) * 28 * h * w / 67e12
        part_s = (8.0 * plan.workspace_floats(c, cx)
                  / chip_smoke.HBM_BYTES_PER_S)
        assert part_s <= 0.5 * ops_s


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


def _fma_mirror(h_prev, x_pad, dg, cx, plan):
    """csrc/weight_grad.cu's FMA loop in numpy, block by block: each unit
    staged into a flat ring slot at the kernel's strides (NaN where the
    kernel stages nothing), each pixel group's 4-pixel quads read from it
    by flat offsets (dg rows, two 4-float halo reads a channel and dy, the
    three dx taps at offsets 0-2 of them), the groups' tiles added in
    group order into the chunk's partial, the chunks in order. Returns
    (dwt, how many times each pixel was taken by the blocks of tile 0)."""
    b_, hh, c, ww = h_prev.shape
    m, cn = 4 * c, cx + c
    mb, cb, rows, tw = plan.block_m, plan.block_c, plan.rows, plan.tw
    ds, hs, cs, dgn, stage, _ = plan.fma_layout()
    n_mt, n_ct = -(-m // mb), -(-cn // cb)
    n_xt, n_rg = -(-ww // tw), -(-hh // rows)
    n_units = b_ * n_rg * n_xt
    ws = np.zeros((plan.chunks, m, 9 * cn))
    seen = np.zeros((b_, hh, ww), int)
    ml, cl = np.arange(mb), np.arange(cb)
    for blk in range(n_mt * n_ct * plan.chunks):
        m0, c0 = blk % n_mt * mb, blk // n_mt % n_ct * cb
        chunk = blk // (n_mt * n_ct)
        acc = np.zeros((plan.groups, mb, cb, 9))
        for u in range(n_units * chunk // plan.chunks,
                       n_units * (chunk + 1) // plan.chunks):
            x0, y0 = u % n_xt * tw, u // n_xt % n_rg * rows
            b = u // (n_xt * n_rg)
            buf = np.full(stage, np.nan)
            for r in range(rows):            # dg rows, zero past the image
                for mm in range(mb):
                    row = np.zeros(tw)
                    y, g = y0 + r, m0 + mm
                    if y < hh and g < m:
                        xs = min(tw, ww - x0)
                        row[:xs] = dg[b, y, g, x0:x0 + xs]
                    buf[(r * mb + mm) * ds:(r * mb + mm) * ds + tw] = row
            for k in range(cb):              # the halo at padded columns
                ch = c0 + k
                for r in range(rows + 2):
                    py, px = y0 + r, x0 + np.arange(tw + 2)
                    row = np.zeros(tw + 2)
                    if ch < cx and py < hh + 2:
                        ok = px < ww + 2
                        row[ok] = x_pad[b, py, ch, px[ok]]
                    elif cx <= ch < cn and 1 <= py <= hh:
                        ok = (px >= 1) & (px <= ww)
                        row[ok] = h_prev[b, py - 1, ch - cx, px[ok] - 1]
                    at = dgn + k * cs + r * hs
                    buf[at:at + tw + 2] = row
            r_end, nqx = min(rows, hh - y0), -(-min(tw, ww - x0) // 4)
            for q in range(r_end * nqx):
                g, r, x = q % plan.groups, q // nqx, 4 * (q % nqx)
                a = buf[((r * mb + ml) * ds + x)[:, None] + np.arange(4)]
                if blk % (n_mt * n_ct) == 0:
                    seen[b, y0 + r, x0 + x:min(x0 + x + 4, ww)] += 1
                for dy in range(3):
                    hv = buf[(dgn + cl * cs + (r + dy) * hs + x)[:, None]
                             + np.arange(8)]
                    for dx in range(3):
                        acc[g, :, :, 3 * dy + dx] += a @ hv[:, dx:dx + 4].T
        tile = acc[0]
        for g in range(1, plan.groups):
            tile = tile + acc[g]
        for k in range(min(cb, cn - c0)):
            ch = c0 + k
            cols = [t * cx + ch if ch < cx else 9 * cx + t * c + ch - cx
                    for t in range(9)]
            nm = min(mb, m - m0)
            ws[chunk][m0:m0 + nm, cols] = tile[:nm, k]
    return ws.sum(0), seen


# (H, W, C, Cx), B: W 13 and 25 (no multiple of 4), H and W off the unit,
# Cx = 0, B = 1, channels not multiples of 8, and the narrowest cells
FMA_MIRROR_GEOMS = [((6, 13, 8, 0), 1), ((5, 25, 8, 8), 2),
                    ((9, 20, 4, 12), 1), ((3, 10, 16, 8), 2)
                    ] + chip_smoke.K5_NARROW_GEOMS


def _fma_groups_plan(b, h, w, c, cx, dtype, groups):
    """The chosen plan (groups None), or the chosen plan cut into
    ``groups`` pixel groups of fewer thread columns (the kernel takes any
    such plan)."""
    plan = fcv.weight_grad_plan(b, h, w, c, cx, dtype)
    if groups is None:
        return plan
    thc = max(1, fcv.FMA_THREADS // (plan.threads_m * groups))
    return fcv.dataclasses.replace(plan, groups=groups, threads_c=thc)


@pytest.mark.parametrize("groups", [None, 1, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom,b", FMA_MIRROR_GEOMS)
def test_fma_mirror_matches_plain(geom, b, dtype, groups):
    hh, ww, c, cx = geom
    rng = np.random.default_rng(1)

    def draw(*shape):   # values the dtype holds exactly
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)

    h_prev = draw(b, hh, c, ww)
    x_pad = (torch.nn.functional.pad(draw(b, hh, cx, ww),
                                     (1, 1, 0, 0, 1, 1)) if cx else None)
    dg = draw(b, hh, 4 * c, ww)
    plan = _fma_groups_plan(b, hh, ww, c, cx, dtype, groups)
    got, seen = _fma_mirror(
        h_prev.double().numpy(),
        None if x_pad is None else x_pad.double().numpy(),
        dg.double().numpy(), cx, plan)
    assert np.array_equal(seen, np.ones_like(seen))   # each pixel once
    want = fcv.weight_grad_ref(h_prev, x_pad, dg, cx=cx, ch=c)
    if dtype == torch.float32:
        # the plain version sums in fp32, the mirror in fp64
        np.testing.assert_allclose(got, want.double().numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    else:   # both round an fp32-or-better sum to bf16 once
        got16 = torch.from_numpy(got).to(torch.bfloat16).float()
        ulp = 2.0 ** -7 * want.float().abs().max().item()
        assert (got16 - want.float()).abs().max().item() <= ulp
