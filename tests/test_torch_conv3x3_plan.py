"""The host-side plan of K3, the pullback conv (``ops/conv3x3.conv3x3_plan``),
the layout of ``csrc/conv3x3.cu``'s tensor-core loop that it sizes, and the
split outputs of ``conv3x3_pullback``.

No card here: the plan is checked for what the kernel takes (tiles that
divide Cout, units that the warps cover, a ring that fits the shared
memory, blocks that fill the SMs, a workspace of one fp32 partial per
part), and a numpy mirror of the kernel's staging (16-byte copies of dg's
channel rows with zero fill, the weight chunk, the transposition to
[pixel][channel], each tap a whole-row offset, the K-chunk order, the
fixed-order sum of the parts and the output map with dx_pad's ring) is
held against the plain version at shapes whose H and W are not multiples
of the unit."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rsis_tpu_torch.ops import conv3x3 as k3
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# (H, W, C, Cx) of the train step's five cells (256x512, hidden 128)
TRAIN_CELLS = [(8, 16, 128, 0), (16, 32, 64, 128), (32, 64, 32, 64),
               (64, 128, 16, 32), (128, 256, 8, 16)]


def _check_mma_plan(b, h, w, cin, cout):
    plan = k3.conv3x3_plan(b, h, w, cin, cout, torch.bfloat16)
    assert plan.mma
    assert plan.wm in k3.WARP_M_TILES and plan.wn in k3.WARP_N_TILES
    assert 1 <= plan.warps_m * plan.warps_n <= 8
    assert cout % plan.block_n == 0
    assert plan.tw % 16 == 0 and plan.tw <= -(-w // 16) * 16
    assert plan.rows * plan.tw == 16 * plan.wm * plan.warps_m
    assert plan.cc in k3.CHUNK_CHANNELS and cin % plan.cc == 0
    assert (cin // plan.cc) % plan.splits == 0
    assert plan.stages in (2, 3)
    assert plan.smem_bytes(cin) <= k3.SMEM_LIMIT
    if plan.stages == 2:   # a third stage would not fit
        assert dataclasses.replace(plan, stages=3).smem_bytes(cin) > \
            k3.SMEM_LIMIT
    units = plan.units(b, h, w)
    assert 1 <= plan.groups <= min(units, k3.SM_COUNT)
    if plan.splits > 1:    # parts only where the units leave SMs idle
        assert plan.groups == units
        assert plan.blocks(cout) <= k3.SM_COUNT
    assert plan.workspace_floats(b, h, w, cout) == (
        plan.splits * b * h * cout * w if plan.splits > 1 else 0)
    return plan


@pytest.mark.parametrize("b", [32, 8])
@pytest.mark.parametrize("cell", range(5))
def test_train_cells_take_the_tensor_cores(b, cell):
    h, w, c, cx = TRAIN_CELLS[cell]
    plan = _check_mma_plan(b, h, w, 4 * c, cx + c)
    # block tiles of at least 128 pixels x min(Cout, 96) channels (each
    # staged weight byte feeds 128 pixels or more) and one wave that fills
    # at least 120 SMs
    assert plan.block_n >= min(cx + c, 96)
    assert plan.rows * plan.tw >= 128
    assert 120 <= plan.blocks(cx + c) <= k3.SM_COUNT


def test_bench_geometry_plans():
    """The plans at B=32, each the fastest of chip_k5_step.py --k3-sweep
    on an H100: cell 0 cut into four parts of its 512 channels; warp tiles
    of 32 pixels x 64 channels there and 64 x 48 (x 24 at cell 4)
    elsewhere; block tiles of 128 x 128, 256 x 96 (two channel tiles at
    cell 1), 512 x 48 and 512 x 24."""
    got = [k3.conv3x3_plan(32, h, w, 4 * c, cx + c, torch.bfloat16)
           for h, w, c, cx in TRAIN_CELLS]
    assert [(p.wm, p.wn) for p in got] == [(2, 8)] + [(4, 6)] * 3 + [(4, 3)]
    assert [p.rows * p.tw for p in got] == [128, 256, 256, 512, 512]
    assert [p.block_n for p in got] == [128, 96, 96, 48, 24]
    assert [p.splits for p in got] == [4, 1, 1, 1, 1]
    assert [p.groups for p in got] == [32, 64, 132, 132, 132]


def test_edge_shapes_cover_every_choice():
    plans = [_check_mma_plan(b, h, w, 4 * c, cx + c)
             for (h, w, c, cx), b in chip_smoke.K3_EDGE_GEOMS]
    shapes = [g for g, _ in chip_smoke.K3_EDGE_GEOMS]
    assert {p.wm for p in plans} == set(k3.WARP_M_TILES)
    assert {p.wn for p in plans} == set(k3.WARP_N_TILES)
    assert {p.splits > 1 for p in plans} == {False, True}
    assert {p.stages for p in plans} == {2, 3}
    # the weight chunk resident (one chunk a block) and streamed
    assert {4 * c // p.cc // p.splits == 1
            for (_, _, c, _), p in zip(shapes, plans)} == {False, True}
    # several output-channel tiles, one of them across the dx / dh border
    assert any((cx + c) // p.block_n > 1
               for (_, _, c, cx), p in zip(shapes, plans))
    assert any(cx % p.block_n for (_, _, c, cx), p in zip(shapes, plans))
    assert any(h % p.rows for (h, *_), p in zip(shapes, plans))
    assert any(w % p.tw for (_, w, *_), p in zip(shapes, plans))
    assert any(w < p.tw for (_, w, *_), p in zip(shapes, plans))
    assert any(cx == 0 for *_, cx in shapes)
    assert any(b == 1 for _, b in chip_smoke.K3_EDGE_GEOMS)
    assert {cx + c for _, _, c, cx in shapes if c == 8} >= {8, 24}


@pytest.mark.parametrize("args", [
    (2, 32, 64, 16, 16, torch.float32),    # fp32
    (2, 8, 24, 24, 16, torch.bfloat16),    # Cin not a multiple of 16
    (2, 8, 24, 32, 12, torch.bfloat16),    # Cout not a multiple of 8
    (2, 8, 20, 32, 16, torch.bfloat16),    # W not a multiple of 8
])
def test_fma_plan(args):
    assert k3.conv3x3_plan(*args) == k3.Conv3x3Plan(mma=False)


def _mirror(dg, wt, cx, plan):
    """csrc/conv3x3.cu's tensor-core loop in numpy (fp64), block by block:
    returns (dx_pad or None, dh) as the output map writes them (NaN where
    nothing was written)."""
    b_, hh, cin, ww = dg.shape
    cout = wt.shape[0]
    rows, tw, cc, nb = plan.rows, plan.tw, plan.cc, plan.block_n
    cps = cin // cc // plan.splits
    n_xt, n_rg = -(-ww // tw), -(-hh // rows)
    n_units = b_ * n_rg * n_xt
    rs, twp, cs = tw + 24, tw + 2, cc + 8
    parts = np.full((plan.splits, b_, hh, cout, ww), np.nan)
    out_dh = np.full((b_, hh, cout - cx, ww), np.nan)
    out_dx = np.full((b_, hh + 2, cx, ww + 2), np.nan) if cx else None
    written = [np.zeros(out_dh.shape, int),
               np.zeros(out_dx.shape, int) if cx else np.zeros(0, int)]
    for blk in range(plan.blocks(cout)):
        group = blk % plan.groups
        split = blk // plan.groups % plan.splits
        n0 = blk // (plan.groups * plan.splits) * nb
        for u in range(n_units * group // plan.groups,
                       n_units * (group + 1) // plan.groups):
            x0, y0 = u % n_xt * tw, u // n_xt % n_rg * rows
            b = u // (n_xt * n_rg)
            acc = np.zeros((rows * tw, nb))
            for c in range(split * cps, (split + 1) * cps):   # K-chunks
                c0 = c * cc
                raw = np.full((rows + 2, cc, rs), np.nan)
                for r in range(rows + 2):     # 16-byte copies, zero fill
                    for q in range(tw // 8 + 2):
                        iy, ix = y0 - 1 + r, x0 - 8 + 8 * q
                        ok = 0 <= iy < hh and 0 <= ix < ww
                        raw[r, :, 8 * q:8 * q + 8] = (
                            dg[b, iy, c0:c0 + cc, ix:ix + 8] if ok else 0)
                wslot = np.concatenate(
                    [wt[n0:n0 + nb, t * cin + c0:t * cin + c0 + cc]
                     for t in range(9)], axis=1)          # [nb][9 cc]
                # 8x8 blocks: raw column 8q + j -> padded column 8q + j - 7
                halo = np.full(((rows + 2) * twp * cs), np.nan)
                for r in range(rows + 2):
                    for g in range(cc // 8):
                        for q in range(tw // 8 + 2):
                            for j in range(8):
                                pc = 8 * q + j - 7
                                if 0 <= pc < twp:
                                    at = (r * twp + pc) * cs + 8 * g
                                    halo[at:at + 8] = raw[r, 8 * g:8 * g + 8,
                                                          8 * q + j]
                # A rows: the m-tile's pixel row, plus the tap's offset
                pix = np.arange(rows * tw)
                base = ((pix // tw) * twp + pix % tw) * cs
                for t in range(9):
                    off = ((t // 3) * twp + t % 3) * cs
                    a = halo[(base + off)[:, None] + np.arange(cc)]
                    acc += a @ wslot[:, t * cc:(t + 1) * cc].T
            ys = slice(y0, min(y0 + rows, hh))
            xs = slice(x0, min(x0 + tw, ww))
            tile = acc.reshape(rows, tw, nb)[:ys.stop - y0, :xs.stop - x0]
            if plan.splits > 1:               # fp32 partial of the part
                dst = parts[split, b, ys, n0:n0 + nb, xs]
                assert np.isnan(dst).all()    # each output once per part
                parts[split, b, ys, n0:n0 + nb, xs] = tile.transpose(0, 2, 1)
            else:
                _epilogue(tile, b, y0, x0, n0, cx, out_dh, out_dx, written)
    if plan.splits > 1:
        out = parts[0]
        for s in range(1, plan.splits):       # the parts in order
            out = out + parts[s]
        _put_all(out, cx, out_dh, out_dx, written)
    assert all((n == 1).all() for n in written)   # each element once
    return out_dx, out_dh


def _epilogue(tile, b, y0, x0, n0, cx, dh, dx_pad, written):
    """The unit's epilogue: channels from cx on into dh; channels below cx
    as 32-bit words of dx_pad's padded columns pc, pc + 1 (pc = x0, x0 +
    2, .. x0 + tw), its own pixels and the ring beside them."""
    n_rows, n_px, nb = tile.shape
    hh, ww = dh.shape[1], dh.shape[3]
    for cl in range(nb):
        co = n0 + cl
        if co >= cx:
            dh[b, y0:y0 + n_rows, co - cx, x0:x0 + n_px] = tile[:, :, cl]
            written[0][b, y0:y0 + n_rows, co - cx, x0:x0 + n_px] += 1
            continue
        ye, xe = y0 + n_rows, x0 + n_px
        for py in range(y0 + (0 if y0 == 0 else 1), ye + 1 + (ye == hh)):
            for pc in range(x0, x0 + n_px + 2 if xe == ww else xe + 1, 2):
                for e in range(2):
                    x = pc - 1 + e
                    own = x0 <= x < xe
                    if own or x == -1 or (x == ww and xe == ww):
                        dx_pad[b, py, co, pc + e] = (
                            tile[py - 1 - y0, x - x0, cl]
                            if own and 1 <= py <= hh else 0)
                        written[1][b, py, co, pc + e] += 1


def _put_all(out, cx, dh, dx_pad, written):
    """The parts' sum through OutMap.put: element by element, each pixel
    of dx also zeroing the ring elements beside it."""
    hh, ww = out.shape[1], out.shape[3]
    dh[:] = out[:, :, cx:]
    written[0] += 1
    if not cx:
        return
    dx_pad[:, 1:-1, :, 1:-1] = out[:, :, :cx]
    written[1][:, 1:-1, :, 1:-1] += 1
    for y in range(hh):
        for x in range(ww):
            edges = [0] * (y == 0) + [hh + 1] * (y == hh - 1)
            cols = [0] * (x == 0) + [ww + 1] * (x == ww - 1)
            for py in edges:
                for pc in [x + 1] + cols:
                    dx_pad[:, py, :, pc] = 0
                    written[1][:, py, :, pc] += 1
            for pc in cols:
                dx_pad[:, y + 1, :, pc] = 0
                written[1][:, y + 1, :, pc] += 1


def _mirror_case(geom, b, plan=None):
    hh, ww, c, cx = geom
    rng = np.random.default_rng(hh + ww + c + cx)
    dg = rng.normal(size=(b, hh, 4 * c, ww)).astype(np.float32)
    wt = rng.normal(size=(cx + c, 36 * c)).astype(np.float32)
    plan = plan or k3.conv3x3_plan(b, hh, ww, 4 * c, cx + c, torch.bfloat16)
    got = _mirror(dg, wt, cx, plan)
    want = k3.conv3x3_pullback_ref(torch.from_numpy(dg),
                                   torch.from_numpy(wt), cx=cx, ch=c)
    for g, w_ in zip(got, want):
        if w_ is None:
            assert g is None
            continue
        w_ = w_.double().numpy()
        assert not np.isnan(g).any()          # every element written
        # the plain version sums in fp32, the mirror in fp64
        np.testing.assert_allclose(g, w_, rtol=0,
                                   atol=1e-5 * np.abs(w_).max())


@pytest.mark.parametrize("geom,b", chip_smoke.K3_EDGE_GEOMS[:4])
def test_kernel_layout_mirror_matches_plain(geom, b):
    _mirror_case(geom, b)


def test_mirror_with_several_units_a_block():
    """Blocks that walk several units in turn (the train cells' ring across
    units), with parts and output-channel tiles."""
    geom, b = (11, 40, 8, 16), 2
    plan = k3.conv3x3_plan(b, *geom[:2], 32, 24, torch.bfloat16)
    plan = dataclasses.replace(plan, groups=3, splits=2, cc=16)
    assert plan.units(b, *geom[:2]) > plan.groups
    _mirror_case(geom, b, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cx", [0, 16])
def test_pullback_is_the_slice_and_pad(cx, dtype):
    """conv3x3_pullback equals the stacked output sliced at cx, its first
    part padded with a zero ring, exactly."""
    c, b, hh, ww = 8, 2, 5, 24
    rng = np.random.default_rng(cx)
    dg = torch.from_numpy(rng.normal(size=(b, hh, 4 * c, ww)).astype(
        np.float32)).to(dtype)
    wt = torch.from_numpy(rng.normal(size=(cx + c, 36 * c)).astype(
        np.float32)).to(dtype)
    dx_pad, dh = k3.conv3x3_pullback(dg, wt, cx=cx, ch=c)
    out = k3.conv3x3_rowmajor(dg, wt, cin=4 * c, cout=cx + c)
    assert dh.is_contiguous() and torch.equal(dh, out[:, :, cx:])
    if not cx:
        assert dx_pad is None
        return
    assert dx_pad.shape == (b, hh + 2, cx, ww + 2) and dx_pad.dtype == dtype
    assert torch.equal(dx_pad[:, 1:-1, :, 1:-1], out[:, :, :cx])
    ring = torch.ones_like(dx_pad, dtype=torch.bool)
    ring[:, 1:-1, :, 1:-1] = False
    assert not dx_pad[ring].any()
