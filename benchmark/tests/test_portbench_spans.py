"""The readers of the port's spans (``spans.py``, ``metrics/*_ms.*.py``):
summed device ms of a span over the window's top-level spans, from
hand-made records, those of earlier sessions left out; nothing without
records or a profiled window, and nothing on a CPU run, whose records
carry no device ms; ``spans.coverage`` on hand-made records."""

from types import SimpleNamespace

import pytest

from benchmark import run, spans
from benchmark.tests import tiny

READERS = {
    "encoder_ms.infer": "rsis.encoder",
    "hoist_ms.infer": "rsis.hoist",
    "decode_ms.infer": "rsis.decode",
    "upsample_ms.infer": "rsis.decode.upsample",
    "output_ms.infer": "rsis.output",
    "encoder_ms.train": "rsis.encoder",
    "decode_ms.train": "rsis.decode",
    "match_ms.train": "rsis.match",
    "backward_ms.train": "rsis.backward",
    "cell_backward_ms.train": "rsis.backward.cell",
    "optim_ms.train": "rsis.optim",
}


def test_every_span_metric_of_the_manifest_is_here():
    spans = {m["name"] for m in tiny.MANIFEST["per_layer"]
             if m["source"] == "program_span"}
    assert spans == set(READERS)


def _records(top: str, name: str, at: int = 0):
    """Two top-level spans, each with the span twice (1 + 2 and 4 + 8 ms)
    and one span of another name, their host intervals from ``at`` ns."""
    def r(name, id, parent, top, device_ms):
        return SimpleNamespace(name=name, id=id, parent=parent, top=top,
                               device_ms=device_ms, host_start_ns=at + id,
                               host_end_ns=at + id + 1)
    out = []
    for k, ms in enumerate(((1.0, 2.0), (4.0, 8.0))):
        t = 10 * k
        out += [r(top, t, None, t, 100.0), r("rsis.other", t + 1, t, t, 50.0)]
        out += [r(name, t + 2 + i, t, t, v) for i, v in enumerate(ms)]
    return out


def _ctx(window=(1000, 2000)):
    return SimpleNamespace(outcome=SimpleNamespace(
        trace=SimpleNamespace(window=window)))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_sums_device_ms_over_top_level_spans(metric, monkeypatch):
    from rsis_tpu_torch.utils import profiling
    name = READERS[metric]
    top = "rsis.forward" if metric.endswith(".infer") else "rsis.train_step"
    read = run.metric_reader(metric)
    # an earlier session's records, before the window, are left out
    monkeypatch.setattr(profiling, "span_records",
                        lambda: (_records(top, name, at=0)
                                 + _records(top, name, at=1000)))
    assert read(_ctx()) == pytest.approx(15.0 / 2)
    # no profiled window (a --trace 0 run) gives nothing
    assert read(SimpleNamespace(outcome=SimpleNamespace(trace=None))) is None
    monkeypatch.setattr(profiling, "span_records", lambda: [])
    assert read(_ctx()) is None
    # records without device ms (no card) give nothing
    monkeypatch.setattr(profiling, "span_records", lambda: [
        SimpleNamespace(**{**vars(r), "device_ms": None})
        for r in _records(top, name, at=1000)])
    assert read(_ctx()) is None


def test_a_port_without_spans_gives_nothing(monkeypatch):
    from rsis_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_records")
    assert all(run.metric_reader(m)(_ctx()) is None for m in READERS)


@pytest.mark.parametrize("name", [tiny.TRAIN_CELL, tiny.INFER_CELL])
def test_a_traced_cpu_run_reports_no_span_metric(name):
    cell = tiny.cell(name, limits={})
    rc, line, _ = tiny.run_tiny(cell, trace=1)
    assert rc == 0
    assert not set(line["metrics"]) & set(READERS)
    from rsis_tpu_torch.utils import profiling
    top = "rsis.forward" if name == tiny.INFER_CELL else "rsis.train_step"
    records = profiling.span_records()
    assert any(r.name == top for r in records)
    assert all(r.device_ms is None for r in records)


def test_coverage_on_hand_made_records():
    recs = _records("rsis.train_step", "rsis.backward.cell")
    recs[3].device_ms = None            # a cell backward without device ms
    got = spans.coverage(recs, window_ns=250_000_000)
    assert [t["name"] for t in got["tops"]] == ["rsis.train_step"] * 2
    assert [t["children_ms"] for t in got["tops"]] == [51.0, 62.0]
    assert [t["share"] for t in got["tops"]] == [0.51, 0.62]
    assert [t["cell_backward_spans"] for t in got["tops"]] == [1, 2]
    assert got["window_ms"] == 250.0
    assert got["tops_over_window"] == pytest.approx(0.8)


def test_a_profiled_window_holds_its_spans():
    # the window's and the records' host clocks agree: a top-level span
    # run inside the harness's profiled window is read as inside it
    from benchmark import trace as tracing
    from rsis_tpu_torch.utils import profiling

    def fn():
        with profiling.span("rsis.forward"):
            with profiling.span("rsis.encoder"):
                pass
    profiling.clear_spans()
    fn()                                # no session: nothing recorded
    tr = tracing.profile(fn)
    tracing.profile(fn)                 # a later session: outside
    names = [r.name for r in spans.records(tr.window)]
    assert names == ["rsis.forward", "rsis.encoder"]
    profiling.clear_spans()
