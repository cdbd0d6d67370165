"""The result line's format, on tiny cells run on the CPU."""

import json

import pytest

from benchmark.tests import tiny

TRAIN_LIMITS = {"loss1_gap": 1.0, "grad_gap": 1e9, "change_gap": 1e9}
INFER_LIMITS = {"mask_gap": 1.0, "mask_answer_gap": 1.0,
                "class_mean_gap": 1.0, "stop_mean_gap": 1.0}


@pytest.mark.parametrize("name,trace", [(tiny.TRAIN_CELL, 0),
                                        (tiny.TRAIN_CELL, 1),
                                        (tiny.INFER_CELL, 0),
                                        (tiny.INFER_CELL, 1)])
def test_last_line(name, trace, capsys):
    limits = TRAIN_LIMITS if name == tiny.TRAIN_CELL else INFER_LIMITS
    cell = tiny.cell(name, limits=dict(limits))
    rc, line, text = tiny.run_tiny(cell, trace=trace)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    wanted = [m["name"] for m in tiny.MANIFEST[kind]
              if "workloads" not in m or name in m["workloads"]]
    assert set(line["metrics"]) <= set(wanted)
    if not trace:
        assert set(line["metrics"]) == set(wanted)
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    checks = line["checks"]
    assert set(checks) == set(limits)
    err = capsys.readouterr().err.strip().splitlines()
    tail = err[-len(checks):]
    assert [ln.split()[1] for ln in tail] == sorted(checks)
    assert all(ln.startswith("check ") and " limit " in ln for ln in tail)
    assert json.loads(text.strip().splitlines()[-1]) == line


@pytest.mark.parametrize("limits", [{}, {"mask_gap": 1.0,
                                         "no_such_reading": 1.0}])
def test_a_limit_without_its_number_is_not_correct(limits):
    cell = tiny.cell(tiny.INFER_CELL, limits=limits)
    rc, line, _ = tiny.run_tiny(cell)
    assert rc == 0 and line["correct"] is False
    assert set(line["checks"]) == set(limits)
