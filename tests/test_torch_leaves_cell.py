"""K1 (the fused decode cell, ``csrc/fused_cell.cu``) at the CVPPP leaf
recipe's cells: a 400x400 input gives a decode pyramid 13, 25, 50, 100 and
200 wide (hidden 128: 128, 64, 32, 16 and 8 channels), and the four
widths that are not multiples of 8 take the staged loop's edge variant
(``cell_plan``'s ``edge``).

On the card (marker ``cuda``; they skip without one): K1 against its
plain version ``fused_cell_rowmajor_ref`` at the five cells at B=1 and
B=256 and at the edge shapes of ``chip_smoke.K1_EDGE_GEOMS`` whose W is
not a multiple of 8, within one bf16 ulp of each output's largest
magnitude (both sides sum the products in fp32 in another order, then
round once; the tolerance ``chip_smoke.py`` holds K1 to), two launches
bit-identical, and each launch counted in
``fused_cell_rowmajor.mma_launches``. Run there with ``python -m pytest
--noconftest -m cuda tests/test_torch_leaves_cell.py``.
"""

import sys
from pathlib import Path

import pytest
import torch

from rsis_tpu_torch.ops import fused_cell as fc
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from test_torch_cell_plan import LEAVES_CELLS  # noqa: E402

ODD_EDGE_GEOMS = [(g, b) for g, b in chip_smoke.K1_EDGE_GEOMS if g[1] % 8]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _check(geom, b, gen):
    hh, ww, ch, cx = geom
    ops = chip_smoke.cell_inputs(geom, b, torch.bfloat16, gen)
    before = (fc.fused_cell_rowmajor.launches,
              fc.fused_cell_rowmajor.mma_launches)
    got = fc.fused_cell_rowmajor(*ops, cx=cx, ch=ch)
    again = fc.fused_cell_rowmajor(*ops, cx=cx, ch=ch)
    assert (fc.fused_cell_rowmajor.launches - before[0],
            fc.fused_cell_rowmajor.mma_launches - before[1]) == (2, 2)
    want = fc.fused_cell_rowmajor_ref(*ops, cx=cx, ch=ch)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("h", "c"), got, again, want):
        tol = chip_smoke.BF16_ULP * w.float().abs().max().item()
        err = chip_smoke.max_err(g, w)
        assert err <= tol, (geom, b, name, err, tol)
        assert torch.equal(g, a), (geom, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 256])
@pytest.mark.parametrize("geom", LEAVES_CELLS)
def test_card_leaves_cells(cuda, geom, b):
    _check(geom, b, torch.Generator(device=cuda).manual_seed(sum(geom) + b))


@pytest.mark.cuda
@pytest.mark.parametrize("geom,b", ODD_EDGE_GEOMS)
def test_card_edge_shapes(cuda, geom, b):
    _check(geom, b, torch.Generator(device=cuda).manual_seed(sum(geom) + b))
