"""The bf16 train step's gradient rule of ``chip_smoke.py``
(``step_grad_rows``, ``step_grad_verdict``), on hand-made gradients.

The card runs it on the real step; here it is checked for what it
decides: a tensor whose plain bf16 path is within the limit of the fp32
path is held to the plain path by the limit; one whose plain path is
itself farther from fp32 is held to fp32, no farther than the plain
path plus the limit; distances are in bf16 ulps of each tensor's plain
scale, floored at 1e-3 of the largest gradient of all."""

import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ULP = cs.BF16_ULP
LIMIT = cs.STEP_GRAD_BF16_ULPS["decoder"]


def _grads(kp, pf, kf_extra=0.0, scale=1.0):
    """One decoder tensor of scale `scale` whose kernel path sits kp ulps
    from the plain path and whose plain path sits pf ulps from fp32 (in
    the other direction, plus kf_extra)."""
    unit = ULP * scale
    g_p = {"decoder.w": torch.tensor([scale, -0.5 * scale])}
    g_k = {"decoder.w": g_p["decoder.w"] + torch.tensor([kp * unit, 0.0])}
    g_f = {"decoder.w": g_p["decoder.w"]
           - torch.tensor([(pf + kf_extra) * unit, 0.0])}
    return g_k, g_p, g_f


def test_rows_measure_three_distances():
    g_k, g_p, g_f = _grads(kp=1.0, pf=2.0)
    row = cs.step_grad_rows(g_k, g_p, g_f)["decoder.w"]
    assert row["group"] == "decoder"
    assert row["kp"] == pytest.approx(1.0, rel=1e-4)
    assert row["pf"] == pytest.approx(2.0, rel=1e-4)
    assert row["kf"] == pytest.approx(3.0, rel=1e-4)


def test_rows_floor_the_scale_of_noise():
    # a bias whose true gradient is zero: its scale is 1e-3 of the largest
    g_p = {"encoder.base.w": torch.tensor([100.0]),
           "encoder.sk1.bias": torch.tensor([1e-6])}
    g_k = {"encoder.base.w": torch.tensor([100.0]),
           "encoder.sk1.bias": torch.tensor([1e-6 + 0.05 * ULP])}
    rows = cs.step_grad_rows(g_k, g_p)
    assert rows["encoder.base.w"]["group"] == "backbone"
    assert rows["encoder.sk1.bias"]["group"] == "decoder"
    assert rows["encoder.sk1.bias"]["kp"] == pytest.approx(0.5, rel=1e-3)
    assert rows["encoder.sk1.bias"]["pf"] is None


@pytest.mark.parametrize("kp,pf,kf_extra,ok,held", [
    (2.9, 0.5, 0.0, True, "plain"),     # passes by the 3-ulp rule
    (3.5, 2.0, 0.0, False, "plain"),    # plain path near fp32: kernel too far
    (3.02, 161.0, -3.02, True, "fp32"),  # both far: kernel no worse
    (1.0, 161.0, 3.5, False, "fp32"),   # both far: kernel 3.5 ulps worse
    (3.5, 3.0, 0.0, False, "plain"),    # the limit itself is the plain rule
])
def test_verdict(kp, pf, kf_extra, ok, held):
    g_k, g_p, g_f = _grads(kp, pf)
    if kf_extra:
        # move the kernel path relative to fp32 only
        unit = ULP
        g_k = {"decoder.w": g_f["decoder.w"]
               + torch.tensor([(pf + kf_extra) * unit, 0.0])}
    row = cs.step_grad_rows(g_k, g_p, g_f)["decoder.w"]
    got_ok, dist, bound, against = cs.step_grad_verdict(row, LIMIT)
    assert (got_ok, against) == (ok, held)
    if held == "fp32":
        assert bound == pytest.approx(row["pf"] + LIMIT)
        assert dist == row["kf"]


def test_verdict_without_fp32_is_the_plain_rule():
    g_k, g_p, _ = _grads(kp=3.5, pf=0.0)
    row = cs.step_grad_rows(g_k, g_p)["decoder.w"]
    assert cs.step_grad_verdict(row, LIMIT)[:2] == (False, row["kp"])
    assert cs.step_grad_verdict(row, 4)[0]
