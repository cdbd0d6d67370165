"""The host-side plan of K1 (the fused decode cell) and K4 (the cell
backward), ``ops/fused_cell.cell_plan``, and the layout of the staged loop
of ``csrc/cell_common.cuh`` that it sizes.

No card here: the plan is checked for what the kernel takes (channel tiles
that divide C, units that the warps cover, chunks that divide the x and h
channels, a ring and epilogue planes that fit the shared memory, blocks
that fill the SMs, a workspace of one fp32 partial per part), and a numpy
mirror of the kernel (16-byte copies of x_pad's rows from their 16-byte
boundary and of h_prev's rows with a zero halo, the weight slot, the
transposition to [pixel][channel] with each row's phase undone, each tap
a whole-row offset, the chunk order, the parts summed in order, the
epilogue's planes and output map) is held against the plain versions in
fp32 at shapes whose H and W are not multiples of the unit, within 1e-5
of the output's largest magnitude (the plain versions sum in fp32, the
mirror in fp64). K1's edge variant, where W is not a multiple of 8 (the
CVPPP recipe's 13-, 25-, 50- and 100-wide cells), is mirrored too: every
row copied from the 16-byte boundary at or before its first element and
read at its phase, h's columns outside the image zeroed, the epilogue's
planes read and written at their rows' phases."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rsis_tpu_torch.ops import fused_cell as fc
from rsis_tpu_torch.ops import fused_cell_vjp as fcv
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# (H, W, C, Cx) of the five cells: the forward at 512x1024 and the train
# step at 256x512 (hidden 128), and the CVPPP recipe's forward at 400x400
FWD_CELLS = [(16, 32, 128, 0), (32, 64, 64, 128), (64, 128, 32, 64),
             (128, 256, 16, 32), (256, 512, 8, 16)]
TRAIN_CELLS = [(8, 16, 128, 0), (16, 32, 64, 128), (32, 64, 32, 64),
               (64, 128, 16, 32), (128, 256, 8, 16)]
LEAVES_CELLS = [(13, 13, 128, 0), (25, 25, 64, 128), (50, 50, 32, 64),
                (100, 100, 16, 32), (200, 200, 8, 16)]


def _kind(backward):
    return "backward" if backward else "forward"


def _check_mma_plan(b, h, w, c, cx, kind):
    plan = fc.cell_plan(b, h, w, c, cx, torch.bfloat16, kind=kind)
    assert plan.mma
    assert plan.wm in fc.CELL_WARP_M and plan.wj in fc.CELL_WARP_J
    assert plan.wm * plan.wj <= fc.MAX_WARP_TILES
    assert 1 <= plan.warps_m * plan.warps_n <= 8
    assert c % plan.block_c == 0
    assert plan.tw % 16 == 0 and plan.tw <= -(-w // 16) * 16
    assert plan.rows * plan.tw == 16 * plan.wm * plan.warps_m
    assert plan.cc in fc.CELL_CHUNKS and c % plan.cc == 0 \
        and cx % plan.cc == 0
    if plan.cc == 8:   # the narrow chunk only where no wider one divides
        assert c % 16 or cx % 16
        assert plan.wj <= 2
    assert plan.chunks(c, cx) % plan.splits == 0
    assert plan.stages in (2, 3)
    assert plan.smem_bytes(c, cx, kind, w=w) <= fc.SMEM_LIMIT
    if plan.stages == 2:   # a third stage would not fit
        assert dataclasses.replace(plan, stages=3).smem_bytes(
            c, cx, kind, w=w) > fc.SMEM_LIMIT
    units = plan.units(b, h, w)
    assert plan.per_sm in (1, 2)
    if plan.per_sm == 2:
        assert plan.two_per_sm(c, cx, kind, w=w) and plan.splits == 1
    per_sm = plan.per_sm
    assert 1 <= plan.groups <= min(units, per_sm * fc.SM_COUNT)
    if plan.splits > 1:    # parts only where the units leave SMs idle
        assert plan.groups == units
    assert plan.blocks(c) <= per_sm * fc.SM_COUNT
    assert plan.workspace_floats(b, h, w, c) == (
        plan.splits * b * h * 4 * c * w if plan.splits > 1 else 0)
    return plan


@pytest.mark.parametrize("b", [32, 4])
@pytest.mark.parametrize("cell", range(5))
def test_forward_cells_take_the_tensor_cores(b, cell):
    h, w, c, cx = FWD_CELLS[cell]
    plan = _check_mma_plan(b, h, w, c, cx, "forward")
    # units of at least 128 pixels, and blocks that fill at least 120 SMs
    assert plan.pixels >= 128
    assert plan.blocks(c) >= 120
    if b == 32 and cell:   # one wave of blocks, each walking its units
        assert plan.units(b, h, w) > plan.groups


@pytest.mark.parametrize("b", [32, 8])
@pytest.mark.parametrize("cell", range(5))
def test_train_cells_take_the_tensor_cores(b, cell):
    h, w, c, cx = TRAIN_CELLS[cell]
    plan = _check_mma_plan(b, h, w, c, cx, "backward")
    assert plan.pixels >= 64
    assert plan.blocks(c) >= 120


@pytest.mark.parametrize("b", [256, 64, 1])
@pytest.mark.parametrize("cell", range(5))
def test_leaves_cells_take_the_tensor_cores(b, cell):
    """The CVPPP recipe at 400x400: cells 0-3 (13-100 wide) on the edge
    variant, cell 4 (200 wide) on the aligned loop; K4 keeps the FMA loop
    at the odd widths."""
    h, w, c, cx = LEAVES_CELLS[cell]
    assert (w % 8 != 0) == (cell < 4)
    plan = _check_mma_plan(b, h, w, c, cx, "forward")
    if b >= 64:
        assert plan.blocks(c) >= 120 and plan.splits == 1
    back = fc.cell_plan(b, h, w, c, cx, torch.bfloat16, kind="backward")
    assert back.mma == (cell == 4)


def test_smoke_pyramids_are_the_cells():
    """chip_smoke.py's concat_geoms gives these tables: each side halved
    five times, rounding up (400 -> 13 at the coarsest cell)."""
    widths = (128, 64, 32, 16, 8)
    assert chip_smoke.concat_geoms(512, 1024, widths) == FWD_CELLS
    assert chip_smoke.concat_geoms(*chip_smoke.TRAIN_HW, widths) == \
        TRAIN_CELLS
    assert chip_smoke.concat_geoms(*chip_smoke.LEAVES_HW, widths) == \
        LEAVES_CELLS


def test_cell4_runs_the_narrow_chunk():
    """C = 8 at cell 4: 8-channel chunks, two taps a k16 step."""
    for kind, cells in (("forward", FWD_CELLS), ("backward", TRAIN_CELLS)):
        plan = fc.cell_plan(32, *cells[4], torch.bfloat16, kind=kind)
        assert plan.cc == 8 and plan.block_c == 8
        plan = fc.cell_plan(32, *cells[3], torch.bfloat16, kind=kind)
        assert plan.cc == 16


def _edge_plans():
    """The edge shapes' plans; K4's only where W is a multiple of 8 (it
    takes the FMA loop elsewhere)."""
    out = []
    for (h, w, c, cx), b in chip_smoke.K1_EDGE_GEOMS:
        for kind in ("forward", "backward"):
            if kind == "backward" and w % 8:
                assert not fc.cell_plan(b, h, w, c, cx, torch.bfloat16,
                                        kind=kind).mma
                continue
            out.append(((h, w, c, cx), b, kind,
                        _check_mma_plan(b, h, w, c, cx, kind)))
    return out


def test_edge_shapes_cover_every_choice():
    plans = _edge_plans()
    got = [p for *_, p in plans]
    assert {p.wm for p in got} == set(fc.CELL_WARP_M)
    assert {p.wj for p in got} == set(fc.CELL_WARP_J)
    assert {p.stages for p in got} == {2, 3}
    assert {p.splits > 1 for p in got} == {False, True}
    assert {p.cc for p in got} >= {8, 16, 32}
    # several channel tiles, the weight chunk resident (one chunk a
    # block) and streamed (several units a block: the cells at B=32)
    assert any(c // p.block_c > 1 for (_, _, c, _), _, _, p in plans)
    assert {p.chunks(c, cx) // p.splits == 1
            for (_, _, c, cx), _, _, p in plans} == {False, True}
    assert any(h % p.rows for (h, *_), _, _, p in plans)
    assert any(w % p.tw for (_, w, *_), _, _, p in plans)
    assert any(w < p.tw for (_, w, *_), _, _, p in plans)
    assert any(cx == 0 for (*_, cx), *_ in plans)
    assert any(b == 1 for _, b in chip_smoke.K1_EDGE_GEOMS)
    # the edge variant: odd W (x_pad's rows at odd phases), W below 8,
    # parts and one part, the narrow and wider chunks, several channel
    # tiles
    edge = [(g, p) for g, _, _, p in plans if g[1] % 8]
    assert any(w % 2 for (_, w, *_), _ in edge)
    assert any(w % 2 == 0 for (_, w, *_), _ in edge)
    assert any(w < 8 for (_, w, *_), _ in edge)
    assert {p.splits > 1 for _, p in edge} == {False, True}
    assert {p.cc == 8 for _, p in edge} == {False, True}
    assert any(c // p.block_c > 1 for (_, _, c, _), p in edge)


@pytest.mark.parametrize("args", [
    (2, 8, 24, 8, 16, torch.float32),     # fp32
    (2, 8, 24, 4, 12, torch.bfloat16),    # C, Cx not multiples of 8
    (2, 8, 20, 8, 16, torch.bfloat16),    # W not a multiple of 8
])
@pytest.mark.parametrize("backward", [False, True])
def test_fma_plan(args, backward):
    """The FMA loop, but K1 at a W that is not a multiple of 8: the staged
    loop's edge variant."""
    plan = fc.cell_plan(*args, kind=_kind(backward))
    if args[2] % 8 and not backward:
        assert plan.mma
    else:
        assert plan == fc.CellPlan(mma=False)


# ---- the numpy mirror of the staged loop ---------------------------------

def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _forward_map(g, v):
    """LstmForward.tile: gates g[4] (S not yet added), planes v[5] (S_i ..
    S_g, c_prev) -> outputs (h, c)."""
    i, f, o = _sig(g[0] + v[0]), _sig(g[1] + v[1]), _sig(g[2] + v[2])
    gg = np.tanh(g[3] + v[3])
    c = f * v[4] + i * gg
    return [o * np.tanh(c), c]


def _backward_map(g, v):
    """LstmBackward.tile: planes v[7] (S_i .. S_g, c_prev, dh, dc) ->
    (dg_i, dg_f, dg_o, dg_g, dc_prev)."""
    i, f, o = _sig(g[0] + v[0]), _sig(g[1] + v[1]), _sig(g[2] + v[2])
    gg = np.tanh(g[3] + v[3])
    cp, dhv, dcv = v[4], v[5], v[6]
    c = f * cp + i * gg
    tc = np.tanh(c)
    dc_tot = dcv + dhv * o * (1 - tc * tc)
    return [dc_tot * gg * i * (1 - i), dc_tot * cp * f * (1 - f),
            dhv * tc * o * (1 - o), dc_tot * i * (1 - gg * gg),
            dc_tot * f]


def _mirror(h_prev, x_pad, c_prev, s_term, wt, cot, cx, plan):
    """The staged loop in numpy (fp64), block by block. cot is (dh, dc) for
    K4, None for K1. Returns the outputs as the kernel writes them ((h, c)
    or (dg, dc_prev); NaN where nothing was written)."""
    b_, hh, ch, ww = h_prev.shape
    rows, tw, cc, ct = plan.rows, plan.tw, plan.cc, plan.block_c
    nxc = cx // cc
    cps = plan.chunks(ch, cx) // plan.splits
    n_xt, n_rg = -(-ww // tw), -(-hh // rows)
    n_units = b_ * n_rg * n_xt
    n_ct = ch // ct
    rs, twp = tw + 24, tw + 2
    cs = cc + (0 if (cc // 8) % 2 else 8)
    backward = cot is not None
    # the planes' sources (in_row) and the outputs (out_row, out_plane)
    src = [s_term[:, :, q * ch:(q + 1) * ch] for q in range(4)] + [c_prev]
    # the edge variant's view of them: (flat tensor, element offset of
    # in_row(row, c))
    flat_src = [(s_term.reshape(-1),
                 lambda row, c, q=q: (row * 4 * ch + q * ch + c) * ww)
                for q in range(4)]
    flat_src += [(t.reshape(-1), lambda row, c: (row * ch + c) * ww)
                 for t in [c_prev] + list(cot or ())]
    if backward:
        src += list(cot)
        outs = [np.full((b_, hh, 4 * ch, ww), np.nan),
                np.full((b_, hh, ch, ww), np.nan)]
        out_rows = [(0, q * ch) for q in range(4)] + [(1, 0)]
        out_plane = [0, 1, 2, 3, 4]
        fmap = _backward_map
    else:
        outs = [np.full((b_, hh, ch, ww), np.nan) for _ in range(2)]
        out_rows = [(0, 0), (1, 0)]
        out_plane = [0, 4]
        fmap = _forward_map
    written = [np.zeros(o.shape, int) for o in outs]
    parts = np.full((plan.splits, b_, hh, 4 * ch, ww), np.nan)
    xflat = x_pad.reshape(-1) if cx else None
    hflat = h_prev.reshape(-1)

    def x_row(b, py, c):
        return ((b * (hh + 2) + py) * cx + c) * (ww + 2)

    for blk in range(plan.blocks(ch)):
        c0 = blk % n_ct * ct
        split = blk // n_ct % plan.splits
        group = blk // (n_ct * plan.splits)
        for u in range(n_units * group // plan.groups,
                       n_units * (group + 1) // plan.groups):
            x0, y0 = u % n_xt * tw, u // n_xt % n_rg * rows
            b = u // (n_xt * n_rg)
            acc = np.zeros((rows * tw, 4 * ct))   # gate-major columns
            for chunk in range(split * cps, (split + 1) * cps):
                is_x = chunk < nxc
                ch0 = (chunk if is_x else chunk - nxc) * cc
                raw = np.full((rows + 2, cc, rs), np.nan)
                halo = np.full(((rows + 2) * twp * cs), np.nan)
                for r in range(rows + 2):
                    for c in range(cc):
                        if ww % 8:
                            line = _edge_line(
                                xflat if is_x else hflat, is_x, b, y0 + r,
                                ch0 + c, x0, hh, ww, cx, ch, tw)
                        elif is_x:   # from the 16-byte boundary, at a phase
                            e0 = (x_row(b, y0 + r, ch0 + c) + x0) & ~7
                            phase = (x_row(b, y0 + r, ch0 + c) + x0) & 7
                            for q in range(tw // 8 + 1):
                                e = e0 + 8 * q
                                raw[r, c, 8 * q:8 * q + 8] = 0
                                if y0 + r < hh + 2 and e < xflat.size:
                                    n = min(8, xflat.size - e)
                                    raw[r, c, 8 * q:8 * q + n] = \
                                        xflat[e:e + n]
                            line = raw[r, c, phase:phase + twp]
                        else:      # h columns x0 - 8 .., zero outside
                            iy = y0 + r - 1
                            for q in range(tw // 8 + 2):
                                ix = x0 - 8 + 8 * q
                                ok = 0 <= iy < hh and 0 <= ix < ww
                                raw[r, c, 8 * q:8 * q + 8] = (
                                    h_prev[b, iy, ch0 + c, ix:ix + 8]
                                    if ok else 0)
                            line = raw[r, c, 7:7 + twp]   # column j - 7
                        at = (r * twp + np.arange(twp)) * cs + c
                        halo[at] = line
                col0 = ch0 if is_x else 9 * cx + ch0
                tap_cols = cx if is_x else ch
                wrows = [q * ch + c0 + cl for q in range(4)
                         for cl in range(ct)]
                wslot = np.concatenate(
                    [wt[wrows, col0 + t * tap_cols:col0 + t * tap_cols + cc]
                     for t in range(9)], axis=1)          # [4 Ct][9 cc]
                pix = np.arange(rows * tw)
                base = ((pix // tw) * twp + pix % tw) * cs
                for t in range(9):
                    off = ((t // 3) * twp + t % 3) * cs
                    a = halo[(base + off)[:, None] + np.arange(cc)]
                    acc += a @ wslot[:, t * cc:(t + 1) * cc].T
            ye, xe = min(y0 + rows, hh), min(x0 + tw, ww)
            tile = acc.reshape(rows, tw, 4, ct)[:ye - y0, :xe - x0]
            if plan.splits > 1:               # fp32 partial of the part
                for q in range(4):
                    dst = parts[split, b, y0:ye, q * ch + c0:
                                q * ch + c0 + ct, x0:xe]
                    assert np.isnan(dst).all()    # once per part
                    parts[split, b, y0:ye, q * ch + c0:q * ch + c0 + ct,
                          x0:xe] = tile[:, :, q].transpose(0, 2, 1)
                continue
            if ww % 8:
                _edge_epilogue(flat_src, acc, outs, written, out_rows,
                               out_plane, fmap, b, y0, x0, c0, ct, rows, tw,
                               b_, hh, ww, ch)
                continue
            # the epilogue: planes [plane][channel][pixel] (zero past the
            # image), outputs into their planes, then the rows out
            etile = np.zeros((len(src), ct, rows, tw))
            for pl, s_ in enumerate(src):
                etile[pl, :, :ye - y0, :xe - x0] = s_[
                    b, y0:ye, c0:c0 + ct, x0:xe].transpose(1, 0, 2)
            g = acc.reshape(rows, tw, 4, ct).transpose(2, 3, 0, 1)
            res = fmap([g[q] for q in range(4)], list(etile))
            for k, val in enumerate(res):
                etile[out_plane[k]] = val
            for k, (o, ofs) in enumerate(out_rows):
                outs[o][b, y0:ye, ofs + c0:ofs + c0 + ct, x0:xe] = etile[
                    out_plane[k], :, :ye - y0, :xe - x0].transpose(1, 0, 2)
                written[o][b, y0:ye, ofs + c0:ofs + c0 + ct, x0:xe] += 1
    if plan.splits > 1:   # the parts in order, then the element epilogue
        tot = parts[0]
        for s in range(1, plan.splits):
            tot = tot + parts[s]
        g = [tot[:, :, q * ch:(q + 1) * ch] for q in range(4)]
        res = fmap(g, src)
        for k, (o, ofs) in enumerate(out_rows):
            outs[o][:, :, ofs:ofs + ch] = res[k]
            written[o][:, :, ofs:ofs + ch] += 1
    assert all((n == 1).all() for n in written)   # each element once
    return outs


def _groups(flat, first, n_groups, row_ok, end=None):
    """The edge variant's copies of one row: n_groups 16-byte groups from
    the boundary at or before element ``first`` of ``flat``, none outside
    [0, end), the last one cut at ``end`` (the tensor's end by default);
    a row outside the tensor is zero. Returns (raw, phase)."""
    end = flat.size if end is None else end
    e0, phase = first & ~7, first & 7
    raw = np.zeros(8 * n_groups)
    for q in range(n_groups):
        e = e0 + 8 * q
        if row_ok and 0 <= e < end:
            n = min(8, end - e)
            raw[8 * q:8 * q + n] = flat[e:e + n]
    return raw, phase


def _edge_line(flat, is_x, b, py, c, x0, hh, ww, cx, ch, tw):
    """One staged row of the halo, padded columns x0 .. x0 + tw + 1, as the
    edge variant's copies and transposition give it: x_pad's row py or h's
    row py - 1 (columns x0 - 1 ..), h's columns outside the image zero."""
    twp = tw + 2
    if is_x:
        first = ((b * (hh + 2) + py) * cx + c) * (ww + 2) + x0
        row_ok = py < hh + 2
    else:
        first = ((b * hh + py - 1) * ch + c) * ww + x0 - 1
        row_ok = 0 <= py - 1 < hh
    raw, phase = _groups(flat, first, tw // 8 + 2, row_ok)
    line = raw[phase:phase + twp].copy()
    if not is_x:
        cols = x0 - 1 + np.arange(twp)
        line[(cols < 0) | (cols >= ww)] = 0
    return line


def _edge_epilogue(flat_src, acc, outs, written, out_rows, out_plane, fmap,
                   b, y0, x0, c0, ct, rows, tw, b_, hh, ww, ch):
    """The edge variant's epilogue of one unit: each plane row's tw / 8 + 1
    copies from its 16-byte boundary (bounded by the plane's end) into a
    row of tw + 8, read at its phase; each output written over its own
    element of plane out_plane(k); the rows stored element by element."""
    er = tw + 8
    raw = np.zeros((len(flat_src), ct, rows, er))
    phases = np.zeros((len(flat_src), ct, rows), int)
    for pl, (flat, off) in enumerate(flat_src):
        end = off(b_ * hh - 1, ch - 1) + ww
        for cl in range(ct):
            for r in range(rows):
                y = min(y0 + r, hh - 1)
                raw[pl, cl, r], phases[pl, cl, r] = _groups(
                    flat, off(b * hh + y, c0 + cl) + x0, tw // 8 + 1,
                    y0 + r < hh, end)
    at = phases[..., None] + np.arange(tw)            # (pl, ct, rows, tw)
    vals = np.take_along_axis(raw, at, axis=-1)
    g = acc.reshape(rows, tw, 4, ct).transpose(2, 3, 0, 1)
    res = fmap([g[q] for q in range(4)], list(vals))
    for k, val in enumerate(res):
        np.put_along_axis(raw[out_plane[k]], at[out_plane[k]], val, axis=-1)
    ye, xe = min(y0 + rows, hh), min(x0 + tw, ww)
    for k, (o, ofs) in enumerate(out_rows):
        pl = out_plane[k]
        got = np.take_along_axis(raw[pl], at[pl], axis=-1)
        outs[o][b, y0:ye, ofs + c0:ofs + c0 + ct, x0:xe] = got[
            :, :ye - y0, :xe - x0].transpose(1, 0, 2)
        written[o][b, y0:ye, ofs + c0:ofs + c0 + ct, x0:xe] += 1


def _case(geom, b, backward, plan=None):
    hh, ww, c, cx = geom
    rng = np.random.default_rng(hh * 7 + ww + c + cx + backward)
    f32 = np.float32
    h_prev = rng.normal(size=(b, hh, c, ww)).astype(f32)
    x_pad = None
    if cx:   # the ring carries values too: the kernel reads it as given
        x_pad = rng.normal(size=(b, hh + 2, cx, ww + 2)).astype(f32)
    c_prev = rng.normal(size=(b, hh, c, ww)).astype(f32)
    s_term = (0.5 * rng.normal(size=(b, hh, 4 * c, ww))).astype(f32)
    wt = (rng.normal(size=(4 * c, 9 * (cx + c)))
          / np.sqrt(9 * (cx + c))).astype(f32)
    cot = None
    if backward:
        cot = tuple(rng.normal(size=(b, hh, c, ww)).astype(f32)
                    for _ in range(2))
    plan = plan or fc.cell_plan(b, hh, ww, c, cx, torch.bfloat16,
                                kind=_kind(backward))
    got = _mirror(h_prev, x_pad, c_prev, s_term, wt, cot, cx, plan)
    t = [torch.from_numpy(a) if a is not None else None
         for a in (h_prev, x_pad, c_prev, s_term, wt)]
    if backward:
        want = fcv.cell_backward_dgates_ref(
            *t, *(torch.from_numpy(a) for a in cot), cx=cx, ch=c)
    else:
        want = fc.fused_cell_rowmajor_ref(*t, cx=cx, ch=c)
    for g, w_ in zip(got, want):
        w_ = w_.double().numpy()
        assert not np.isnan(g).any()          # every element written
        np.testing.assert_allclose(g, w_, rtol=0,
                                   atol=1e-5 * np.abs(w_).max())


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("geom,b", chip_smoke.K1_EDGE_GEOMS[:4])
def test_kernel_layout_mirror_matches_plain(geom, b, backward):
    _case(geom, b, backward)


@pytest.mark.parametrize("backward", [False, True])
def test_mirror_with_parts_tiles_and_several_units(backward):
    """Blocks that walk several units in turn (the ring across units),
    with parts, channel tiles and x chunks that start off the 16-byte
    boundary of x_pad's rows."""
    geom, b = (11, 40, 16, 24), 2
    plan = fc.CellPlan(True, wm=1, wj=1, warps_m=2, warps_n=1, rows=2,
                       tw=16, cc=8, stages=3, splits=5, groups=3)
    assert plan.units(b, *geom[:2]) > plan.groups
    assert geom[2] // plan.block_c == 2
    _case(geom, b, backward, plan)


EDGE_GEOMS = [g for g in chip_smoke.K1_EDGE_GEOMS if g[0][1] % 8]


@pytest.mark.parametrize("geom,b", EDGE_GEOMS)
def test_edge_mirror_matches_plain(geom, b):
    """K1's edge variant at the edge shapes whose W is not a multiple of 8
    (odd and even W, W below 8, parts and one part)."""
    _case(geom, b, False)


@pytest.mark.parametrize("w", [13, 25, 50, 100])
def test_edge_mirror_at_leaves_widths(w):
    """The CVPPP recipe's odd-width cells at their own width and channels,
    a few rows tall (the mirror walks every block in numpy): the plan's
    unit at B=2, and several units a block across rows and column tiles
    (W = 100: two column tiles of 64)."""
    h, _, c, cx = next(g for g in LEAVES_CELLS if g[1] == w)
    geom = (5, w, c, cx)
    _case(geom, 2, False)
    plan = fc.cell_plan(2, *geom, torch.bfloat16)
    several = dataclasses.replace(plan, rows=2, tw=16 * plan.wm
                                  * plan.warps_m // 2, splits=1, groups=3)
    assert several.units(2, *geom[:2]) > several.groups
    _case(geom, 2, False, several)


@pytest.mark.parametrize("backward", [False, True])
def test_mirror_with_wide_chunks(backward):
    """32-channel chunks of x and h, a unit taller than the image's last
    row group, one part, groups of several units."""
    geom, b = (7, 24, 32, 32), 1
    plan = fc.CellPlan(True, wm=2, wj=2, warps_m=2, warps_n=2, rows=4,
                       tw=16, cc=32, stages=2, splits=1, groups=2)
    assert plan.units(b, *geom[:2]) == 4
    _case(geom, b, backward, plan)
