"""The check against planted faults and the control, on tiny cells on
the CPU: the harness's run with the timed path broken underneath must
come out not correct, the sound run correct, under the cells' own
limits (``limits/<cell>.json``)."""

import pytest
import torch

from benchmark import calibrate, checks
from benchmark.tests import tiny


def _train_cell():
    return tiny.cell(tiny.TRAIN_CELL)


def _infer_cell():
    return tiny.cell(tiny.INFER_CELL)


def test_sound_train_run_is_correct():
    rc, line, _ = tiny.run_tiny(_train_cell())
    assert rc == 0 and line["correct"] is True, line["checks"]


def test_sound_infer_run_is_correct():
    rc, line, _ = tiny.run_tiny(_infer_cell())
    assert rc == 0 and line["correct"] is True, line["checks"]


def _unchanged(monkeypatch):
    import rsis_tpu_torch.train.step as step
    monkeypatch.setattr(step, "update_groups",
                        lambda cfg, params, grads, enc, dec, gate: (enc, dec))


def _half_batch(monkeypatch):
    import rsis_tpu_torch.train.step as step
    decode = step.decode_batch

    def half(cfg, batch, device):
        return tuple(t[:t.shape[0] // 2] for t in decode(cfg, batch, device))
    monkeypatch.setattr(step, "decode_batch", half)


def _loss_altered(monkeypatch):
    import rsis_tpu_torch.train.step as step
    losses = step._losses

    def altered(*args, **kw):
        total, parts = losses(*args, **kw)
        return total * 1.02, parts
    monkeypatch.setattr(step, "_losses", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _loss_altered])
def test_train_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, line, _ = tiny.run_tiny(_train_cell())
    assert rc == 0 and line["correct"] is False, line["checks"]


def _answer_altered(monkeypatch):
    import rsis_tpu_torch.evals.forward as fwd
    forward = fwd.forward

    def altered(*args, **kw):
        masks, clss, stops = forward(*args, **kw)
        masks = masks.clone()
        masks[0, 0] = 1.0 - masks[0, 0]
        return masks, clss, stops
    monkeypatch.setattr(fwd, "forward", altered)


def _infer_half_batch(monkeypatch):
    import rsis_tpu_torch.evals.forward as fwd
    forward = fwd.forward

    def half(cfg, encoder, decoder, x, T=None, plain=False):
        out = forward(cfg, encoder, decoder, x[:x.shape[0] // 2], T=T,
                      plain=plain)
        return tuple(torch.cat([t, t]) for t in out)
    monkeypatch.setattr(fwd, "forward", half)


@pytest.mark.parametrize("fault", [_answer_altered, _infer_half_batch])
def test_infer_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, line, _ = tiny.run_tiny(_infer_cell())
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_train_control_is_not_correct():
    """The reference one precision below the configuration's (TF32 for
    fp32 with TF32 off) in the program's place."""
    cell = _train_cell()
    numbers = calibrate.train_readings(cell, 2**31 + 11, "cpu",
                                       calibrate.control_precision(cell))
    assert calibrate.control_precision(cell) == "tf32"
    assert checks.verdict(numbers, cell.limits)[0] is False, numbers


def test_infer_control_is_not_correct():
    cell = tiny.cell(tiny.INFER_CELL, compute_dtype="bfloat16")
    cell.config["tf32"] = None
    assert calibrate.control_precision(cell) == "fp8"
    numbers = calibrate.infer_readings(cell, 2**31 + 11, "cpu", "fp8")
    assert checks.verdict(numbers, cell.limits)[0] is False, numbers
