"""The hoisted S terms under autograd (``models/rowmajor_decoder.
_hoist_cells_rowmajor``): every decode step reads the S terms themselves,
in the compute dtype, and autograd sums their cotangent over the steps in
that dtype, as the reference's scan does."""

import pytest
import torch

from rsis_tpu_torch.models import rowmajor_decoder as rmd
from rsis_tpu_torch.models.decoder import RSISDecoder
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hoist_keeps_s_terms_in_the_graph(dtype):
    torch.manual_seed(0)
    dec = RSISDecoder(hidden_size=16, num_classes=4, skip_mode="concat")
    skips = [torch.randn(2, c, 2 ** (i + 1), 2 ** (i + 2)).to(dtype)
             for i, c in enumerate((16, 16, 8, 4, 2))]
    cells = rmd._hoist_cells_rowmajor(dec, skips, "concat", dtype)
    with torch.no_grad():
        plain = rmd._hoist_cells_rowmajor(dec, skips, "concat", dtype)
    for c, p in zip(cells, plain):
        assert c["s"].dtype == dtype and c["s"].requires_grad
        assert not p["s"].requires_grad
        assert torch.equal(c["s"], p["s"])


def test_bf16_decoder_gradients_through_the_steps():
    # the whole decode under autograd in bf16: every gate weight gets a
    # finite gradient, the skip part of cell 0's through the S terms
    torch.manual_seed(1)
    dec = RSISDecoder(hidden_size=16, num_classes=4, skip_mode="sum")
    skips = [torch.randn(2, c, 2 ** (i + 1), 2 ** (i + 2)).to(
        torch.bfloat16) for i, c in enumerate((16, 16, 8, 4, 2))]
    cells = rmd._hoist_cells_rowmajor(dec, skips, "sum", torch.bfloat16)
    carry = rmd.init_carry_rowmajor(skips, 16, torch.bfloat16)
    total = 0
    for _ in range(4):
        (h, cls, stop), carry = rmd.rowmajor_decoder_step(dec, cells, carry,
                                                          plain=True)
        total = total + h.float().sum() + cls.float().sum()
    total.backward()
    for cell in dec.clstm_list:
        g = cell.Gates.weight.grad
        assert g is not None and torch.isfinite(g).all()
        assert g.abs().sum() > 0
