"""The S terms' cotangent summed over the decode steps in fp32
(``models/rowmajor_decoder._FP32Sum``): bf16 S terms read by T steps get
the fp32 sum of their T bf16 cotangents, rounded once (exactly), where
autograd alone would round the running sum T times; the steps read the S
terms' own bf16 data (no copy); the fp32 path and inference take no
stand-in."""

import numpy as np
import pytest
import torch

from rsis_tpu_torch.models import rowmajor_decoder as rmd
from rsis_tpu_torch.models.decoder import RSISDecoder

SHAPES = [(2, 3, 8, 5), (2, 6, 4, 9)]


def _steps(T, anchored, seed=0):
    """T steps reading two bf16 S terms, each step's loss weighting them
    with random bf16 cotangents; returns the S terms' gradients and the
    cotangents."""
    rng = np.random.default_rng(seed)
    ss = [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        torch.bfloat16).requires_grad_() for sh in SHAPES]
    cells = [{"s": s, "s_sum": None} for s in ss]
    if anchored:
        acc = [None] * len(ss)
        s_sum = (rmd._FP32Sum.apply(acc, *ss), acc)
        cells = [{"s": s.detach(), "s_sum": s_sum} for s in ss]
    cots = [[torch.from_numpy(rng.normal(size=sh).astype(np.float32)
                              * 10.0 ** rng.integers(-3, 3)).to(
                                  torch.bfloat16) for sh in SHAPES]
            for _ in range(T)]
    total = 0
    for gs in cots:
        reads = rmd._s_terms(cells)
        for read, s, g in zip(reads, ss, gs):
            assert read.dtype == torch.bfloat16
            assert read.data_ptr() == s.data_ptr()
            total = total + (read.float() * g.float()).sum()
    total.backward()
    return [s.grad for s in ss], cots


@pytest.mark.parametrize("T", [5, 20])
def test_bf16_cotangent_summed_in_fp32(T):
    got, cots = _steps(T, anchored=True)
    naive, _ = _steps(T, anchored=False)
    for i, g in enumerate(got):
        want = torch.stack([c[i].float() for c in cots]).sum(0).to(
            torch.bfloat16)
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, want)
        assert not torch.equal(naive[i], want)


def test_hoist_anchors_only_bf16_under_autograd():
    torch.manual_seed(0)
    dec = RSISDecoder(hidden_size=16, num_classes=4, skip_mode="concat")
    skips = [torch.randn(2, c, 2 ** (i + 1), 2 ** (i + 2))
             for i, c in enumerate((16, 16, 8, 4, 2))]
    for dtype in (torch.float32, torch.bfloat16):
        sk = [s.to(dtype) for s in skips]
        cells = rmd._hoist_cells_rowmajor(dec, sk, "concat", dtype)
        assert all((c["s_sum"] is not None) == (dtype == torch.bfloat16)
                   for c in cells)
        with torch.no_grad():
            plain = rmd._hoist_cells_rowmajor(dec, sk, "concat", dtype)
        for c, p in zip(cells, plain):
            assert p["s_sum"] is None
            assert torch.equal(c["s"], p["s"])


def test_bf16_decoder_gradients_through_the_steps():
    # the whole decode under autograd in bf16: every gate weight gets a
    # finite gradient, and the skip part of cell 0's gets the fp32 sum
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
