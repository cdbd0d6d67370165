"""The host-side plan of K8 (the NCHW ConvLSTM step of the mul decode),
``ops/fused_cell.cell_plan(..., kind="step")``, and the NCHW operand
policy of the staged loop of ``csrc/cell_common.cuh`` that it sizes.

No card here: the plan is checked for what the kernel takes (as
``test_torch_cell_plan`` checks K1's and K4's) at the mul decode's five
cells and at ``chip_smoke.K8_EDGE_GEOMS``, and a numpy mirror of the kernel
with ``NchwLayout`` (16-byte copies of x's and h_prev's NCHW rows from
column x0 - 8 with a zero SAME halo, the packed weight's slot, the
transposition to [pixel][channel], each tap a whole-row offset, the x
chunks before the h chunks, the parts summed in order with the bias added
by the element epilogue, the tile's biases in shared memory, the two
epilogue planes and the NCHW output map) is held against
``clstm_step_ref`` in fp32, within 1e-5 of the output's largest magnitude
(the plain version sums in fp32, the mirror in fp64), with every output
element written once."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rsis_tpu_torch.ops import clstm_step as k8
from rsis_tpu_torch.ops import fused_cell as fc
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from test_torch_cell_plan import _check_mma_plan  # noqa: E402

# (H, W, Cx, C) of the mul decode's five cells at 512x1024, hidden 128
MUL_CELLS = [(16, 32, 128, 128), (32, 64, 128, 64), (64, 128, 64, 32),
             (128, 256, 32, 16), (256, 512, 16, 8)]


def _plan(geom, b):
    hh, ww, cx, c = geom
    return _check_mma_plan(b, hh, ww, c, cx, "step")


@pytest.mark.parametrize("b", [32, 4])
@pytest.mark.parametrize("cell", range(5))
def test_mul_cells_take_the_tensor_cores(b, cell):
    plan = _plan(MUL_CELLS[cell], b)
    assert plan.pixels >= 128
    assert plan.blocks(MUL_CELLS[cell][3]) >= 120


def test_cell4_runs_the_narrow_chunk():
    """C = 8 at cell 4: 8-channel chunks, two taps a k16 step."""
    for b in (32, 4):
        plan = _plan(MUL_CELLS[4], b)
        assert plan.cc == 8 and plan.block_c == 8
        assert _plan(MUL_CELLS[3], b).cc == 16


def test_step_kind_counts_two_planes_and_the_bias():
    """K8's block: two epilogue planes (c_prev in; h and c out) and its 4
    Ct fp32 biases, against K1's five planes."""
    plan = fc.CellPlan(True, 2, 2, 4, 2, 4, 32, 16, 3, 1, 10)
    fwd = plan.smem_bytes(64, 32, "forward", w=32)
    step = plan.smem_bytes(64, 32, "step", w=32)
    assert fwd - step == 2 * 3 * plan.block_c * (plan.pixels + 8) \
        - 16 * plan.block_c


def test_edge_shapes_cover_every_choice():
    plans = [(geom, b, _plan(geom, b)) for geom, b in chip_smoke.K8_EDGE_GEOMS]
    got = [p for *_, p in plans]
    assert {p.wm for p in got} == set(fc.CELL_WARP_M)
    assert {p.wj for p in got} == set(fc.CELL_WARP_J)
    assert {p.stages for p in got} == {2, 3}
    assert {p.splits > 1 for p in got} == {False, True}
    assert {p.per_sm for p in got} == {1, 2}
    assert {p.cc for p in got} >= {8, 16, 32}
    assert any(c // p.block_c > 1 for (_, _, _, c), _, p in plans)
    # the weight chunk resident (one chunk a block) and streamed
    assert {p.chunks(c, cx) // p.splits == 1
            for (_, _, cx, c), _, p in plans} == {False, True}
    assert any(h % p.rows for (h, *_), _, p in plans)
    assert any(w % p.tw for (_, w, *_), _, p in plans)
    assert any(w < p.tw for (_, w, *_), _, p in plans)
    assert any(b == 1 for _, b, _ in plans)
    assert any(h % 2 for (h, *_), _, _ in plans)


@pytest.mark.parametrize("args", [
    (2, 8, 24, 8, 16, torch.float32),     # fp32
    (2, 9, 20, 8, 16, torch.bfloat16),    # W not a multiple of 8
    (2, 8, 24, 4, 12, torch.bfloat16),    # C, Cx not multiples of 8
])
def test_fma_plan(args):
    assert fc.cell_plan(*args, kind="step") == fc.CellPlan(mma=False)


def test_packed_weight_is_pack_cell_weights():
    w = torch.randn(32, 24, 3, 3)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(k8.packed_weight(w, dtype),
                           fc.pack_cell_weights(w, 16, 8, dtype))
    assert torch.equal(k8.packed_weight(w[:, 16:], torch.float32),
                       fc.pack_cell_weights(w[:, 16:], 0, 8, torch.float32))


# ---- the numpy mirror of the staged loop with NchwLayout ------------------

def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _update(g, cp):
    """LstmStep.tile on the gate sums g[4] (bias added) and c_prev."""
    c = _sig(g[1]) * cp + _sig(g[0]) * np.tanh(g[3])
    return [_sig(g[2]) * np.tanh(c), c]


def _mirror(x, h_prev, c_prev, wt, bias, plan):
    """The staged loop with NchwLayout in numpy (fp64), block by block.
    Returns (h, c) as the kernel writes them (NaN where nothing was
    written)."""
    b_, ch, hh, ww = h_prev.shape
    cx = x.shape[1]
    rows, tw, cc, ct = plan.rows, plan.tw, plan.cc, plan.block_c
    nxc = cx // cc
    cps = plan.chunks(ch, cx) // plan.splits
    n_xt, n_rg = -(-ww // tw), -(-hh // rows)
    n_units = b_ * n_rg * n_xt
    n_ct = ch // ct
    rs, twp = tw + 24, tw + 2
    cs = cc + (0 if (cc // 8) % 2 else 8)
    planes = fc.EPI_PLANES["step"]
    out_plane = [0, 1]   # h into c_prev's plane, c into the second
    outs = [np.full(h_prev.shape, np.nan) for _ in range(2)]
    written = [np.zeros(h_prev.shape, int) for _ in range(2)]
    parts = np.full((plan.splits, b_, hh, 4 * ch, ww), np.nan)
    for blk in range(plan.blocks(ch)):
        c0 = blk % n_ct * ct
        split = blk // n_ct % plan.splits
        group = blk // (n_ct * plan.splits)
        # the tile's gate biases, [gate][Ct]
        bias_s = np.array([bias[i // ct * ch + c0 + i % ct]
                           for i in range(4 * ct)])
        for u in range(n_units * group // plan.groups,
                       n_units * (group + 1) // plan.groups):
            x0, y0 = u % n_xt * tw, u // n_xt % n_rg * rows
            b = u // (n_xt * n_rg)
            acc = np.zeros((rows * tw, 4 * ct))   # gate-major columns
            for chunk in range(split * cps, (split + 1) * cps):
                is_x = chunk < nxc
                ch0 = (chunk if is_x else chunk - nxc) * cc
                src = x if is_x else h_prev
                raw = np.full((rows + 2, cc, rs), np.nan)
                halo = np.full(((rows + 2) * twp * cs), np.nan)
                for r in range(rows + 2):
                    iy = y0 + r - 1
                    for c in range(cc):
                        # columns x0 - 8 .., zero outside the image
                        for q in range(tw // 8 + 2):
                            ix = x0 - 8 + 8 * q
                            ok = 0 <= iy < hh and 0 <= ix < ww
                            raw[r, c, 8 * q:8 * q + 8] = (
                                src[b, ch0 + c, iy, ix:ix + 8] if ok else 0)
                        at = (r * twp + np.arange(twp)) * cs + c
                        halo[at] = raw[r, c, 7:7 + twp]   # column j - 7
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
            if plan.splits > 1:   # fp32 partial of the part, (B, H, 4C, W)
                for q in range(4):
                    dst = parts[split, b, y0:ye, q * ch + c0:
                                q * ch + c0 + ct, x0:xe]
                    assert np.isnan(dst).all()    # once per part
                    dst[...] = tile[:, :, q].transpose(0, 2, 1)
                continue
            # the epilogue: c_prev's plane (zero past the image), the bias
            # on the gate sums, the outputs into their planes, NCHW rows out
            etile = np.zeros((planes, ct, rows, tw))
            etile[0, :, :ye - y0, :xe - x0] = c_prev[b, c0:c0 + ct, y0:ye,
                                                     x0:xe]
            g = acc.reshape(rows, tw, 4, ct).transpose(2, 3, 0, 1)
            g = [g[q] + bias_s[q * ct:(q + 1) * ct, None, None]
                 for q in range(4)]
            for k, val in enumerate(_update(g, etile[0])):
                etile[out_plane[k]] = val
            for k in range(2):
                outs[k][b, c0:c0 + ct, y0:ye, x0:xe] = etile[
                    out_plane[k], :, :ye - y0, :xe - x0]
                written[k][b, c0:c0 + ct, y0:ye, x0:xe] += 1
    if plan.splits > 1:   # the parts in order, then the element epilogue
        tot = parts[0]
        for s in range(1, plan.splits):
            tot = tot + parts[s]
        g = [tot[:, :, q * ch:(q + 1) * ch].transpose(0, 2, 1, 3)
             + bias[q * ch:(q + 1) * ch, None, None] for q in range(4)]
        for k, val in enumerate(_update(g, c_prev)):
            outs[k][...] = val
            written[k] += 1
    assert all((n == 1).all() for n in written)   # each element once
    return outs


def _case(geom, b, plan=None):
    hh, ww, cx, c = geom
    rng = np.random.default_rng(hh * 7 + ww + c + cx)
    f32 = np.float32
    x = rng.normal(size=(b, cx, hh, ww)).astype(f32)
    h_prev = rng.normal(size=(b, c, hh, ww)).astype(f32)
    c_prev = rng.normal(size=(b, c, hh, ww)).astype(f32)
    weight = (rng.normal(size=(4 * c, cx + c, 3, 3))
              / np.sqrt(9 * (cx + c))).astype(f32)
    bias = (0.5 * rng.normal(size=4 * c)).astype(f32)
    plan = plan or _plan(geom, b)
    wt = k8.packed_weight(torch.from_numpy(weight), torch.float32).numpy()
    got = _mirror(x, h_prev, c_prev, wt, bias, plan)
    want = k8.clstm_step_ref(*(torch.from_numpy(a) for a in
                               (x, h_prev, c_prev, weight, bias)))
    for g, w_ in zip(got, want):
        w_ = w_.double().numpy()
        assert not np.isnan(g).any()          # every element written
        np.testing.assert_allclose(g, w_, rtol=0,
                                   atol=1e-5 * np.abs(w_).max())


@pytest.mark.parametrize("geom,b", chip_smoke.K8_EDGE_GEOMS[:4])
def test_kernel_layout_mirror_matches_plain(geom, b):
    _case(geom, b)


def test_mirror_at_a_cut_mul_cell():
    """Cell 4's widths (Cx 16, C 8: the narrow chunk) on a cut image,
    with the plan the cell takes there."""
    _case((12, 64, 16, 8), 1)


def test_mirror_with_parts_tiles_and_several_units():
    """Blocks that walk several units in turn (the ring across units),
    with parts, channel tiles and x chunks beside h chunks in one part."""
    geom, b = (11, 40, 24, 16), 2
    plan = fc.CellPlan(True, wm=1, wj=1, warps_m=2, warps_n=1, rows=2,
                       tw=16, cc=8, stages=3, splits=5, groups=3)
    assert plan.units(b, *geom[:2]) > plan.groups
    assert geom[3] // plan.block_c == 2
    _case(geom, b, plan)


def test_mirror_with_wide_chunks():
    """32-channel chunks of x and h, a unit taller than the image's last
    row group, one part, groups of several units."""
    geom, b = (7, 24, 32, 32), 1
    plan = fc.CellPlan(True, wm=2, wj=2, warps_m=2, warps_n=2, rows=4,
                       tw=16, cc=32, stages=2, splits=1, groups=2)
    assert plan.units(b, *geom[:2]) == 4
    _case(geom, b, plan)
