"""The port's spans (``utils/profiling.span``) on the tiny configuration:

- off (no profiler session) a forward and a train step record nothing and
  never enter ``record_function``;
- on (under ``torch.profiler``) each records the layers' spans with their
  counts a call, nested under one top-level span, each host interval
  within 50 us of the profiler's own event of that name;
- outputs and the train state are bit-equal with spans on and off;
- ``span_table``'s self times on hand-made records;
- ``profiling.trace`` starts with no records;
- spans opened on more threads than cores at once lose no record and
  nest in their own thread's open span."""

import gc
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import one_torch_thread  # noqa: F401

from rsis_tpu_torch import Config
from rsis_tpu_torch.data.synthetic import synthetic_wire_batch
from rsis_tpu_torch.evals.forward import make_forward
from rsis_tpu_torch.models.rsis import init_weights
from rsis_tpu_torch.train import step as port_step
from rsis_tpu_torch.utils import profiling
from rsis_tpu_torch.utils.profiling import SpanRecord

T = 3
CFG = Config(base_model="tiny", hidden_size=16, num_classes=4, imsize=32,
             maxseqlen=T, gt_maxseqlen=5, batch_size=2, use_class_loss=True,
             use_stop_loss=True)
WEIGHTS = init_weights(CFG, torch.Generator().manual_seed(0))
BATCH = synthetic_wire_batch(np.random.default_rng(0), 2, 32, 32, 5, 4)
IMAGES = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))

FORWARD = {"rsis.forward": 1, "rsis.encoder": 1, "rsis.decode": 1,
           "rsis.hoist": 1, "rsis.decode.upsample": 4 * T, "rsis.output": 1}
TRAIN = {"rsis.train_step": 1, "rsis.input": 1, "rsis.encoder": 1,
         "rsis.decode": 1, "rsis.hoist": 1, "rsis.decode.upsample": 4 * T,
         "rsis.match": 1, "rsis.losses": 1, "rsis.backward": 1,
         "rsis.backward.cell": 5 * T, "rsis.optim": 1}
PARENTS = {"rsis.encoder": ("rsis.forward", "rsis.train_step"),
           "rsis.decode": ("rsis.forward", "rsis.train_step"),
           "rsis.output": ("rsis.forward",),
           "rsis.hoist": ("rsis.decode",),
           "rsis.decode.upsample": ("rsis.decode",),
           "rsis.input": ("rsis.train_step",),
           "rsis.match": ("rsis.train_step",),
           "rsis.losses": ("rsis.train_step",),
           "rsis.backward": ("rsis.train_step",),
           "rsis.backward.cell": ("rsis.backward",),
           "rsis.optim": ("rsis.train_step",)}


def run_forward():
    fn = make_forward(CFG, T=T, device="cpu")
    return fn(WEIGHTS, IMAGES)


def run_train_step():
    state = port_step.create_train_state(CFG, WEIGHTS, device="cpu")
    train_step, _ = port_step.make_train_step(CFG, T=T, device="cpu")
    flags = port_step.StepFlags.from_config(CFG)
    state, metrics = train_step(state, BATCH, flags)
    return state.tensors(), metrics


def profiled(fn):
    """fn's result under a CPU profiler session, with the session. A first
    session runs fn to warm ``record_function`` up on every thread that
    opens a span; the collector stays off in the second, whose records
    are kept."""
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    profiling.clear_spans()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        gc.enable()
    return out, prof


def test_spans_off_record_nothing_and_enter_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    profiling.clear_spans()
    run_forward()
    run_train_step()
    assert profiling.span_records() == []


def host_offsets(records, prof, counts):
    """The largest distance (ns) between a record's host interval and the
    profiler's own event of the same name and rank, at either end."""
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in counts:
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    worst = 0
    for name in counts:
        mine = sorted((r.host_start_ns, r.host_end_ns) for r in records
                      if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            worst = max(worst, abs(a - c), abs(b - d))
    return worst


@pytest.mark.parametrize("fn,counts", [(run_forward, FORWARD),
                                       (run_train_step, TRAIN)],
                         ids=["forward", "train_step"])
def test_spans_on_record_each_layer_under_one_top(fn, counts):
    # a thread that the system preempts while it enters a range moves
    # that one stamp: such a session is made again, at most three times
    for attempt in range(3):
        _, prof = profiled(fn)
        records = profiling.span_records()
        by_id = {r.id: r for r in records}
        tops = [r for r in records if r.parent is None]
        assert len(tops) == 1 and tops[0].name in counts
        assert {r.top for r in records} == {tops[0].id}
        got = {}
        for r in records:
            got[r.name] = got.get(r.name, 0) + 1
            if r.parent is not None:
                assert by_id[r.parent].name in PARENTS[r.name], r.name
            assert r.host_start_ns <= r.host_end_ns
            assert r.device_ms is None          # no card here
        assert got == counts
        table = profiling.span_table(records)
        assert {k: row.count for k, row in table.items()} == counts
        # each host interval on the profiler's clock: within 50 us of the
        # profiler's event of the same name and rank, at both ends
        worst = host_offsets(records, prof, counts)
        if worst < 50_000:
            break
    assert worst < 50_000, worst


@pytest.mark.parametrize("fn", [run_forward, run_train_step],
                         ids=["forward", "train_step"])
def test_outputs_bit_equal_with_spans_on_and_off(fn):
    off = fn()
    on, _ = profiled(fn)
    assert profiling.span_records()
    flat_off = off[0].values() if isinstance(off[0], dict) else off
    flat_on = on[0].values() if isinstance(on[0], dict) else on
    for a, b in zip(flat_off, flat_on):
        assert torch.equal(a, b)
    if isinstance(off[0], dict):
        assert list(off[0]) == list(on[0])
        assert torch.equal(off[1], on[1])


def test_span_table_self_times_on_hand_made_records():
    recs = [SpanRecord("step", 0, None, 0, 0, 10_000_000, 9.0),
            SpanRecord("enc", 1, 0, 0, 1_000_000, 3_000_000, 2.5),
            SpanRecord("bwd", 2, 0, 0, 3_000_000, 9_000_000, 6.0),
            SpanRecord("cell", 3, 2, 0, 4_000_000, 5_000_000, 1.5),
            SpanRecord("cell", 4, 2, 0, 5_000_000, 6_500_000, 2.0),
            SpanRecord("step", 5, None, 5, 20_000_000, 24_000_000, 3.0)]
    table = profiling.span_table(recs)
    assert table["step"] == (2, 14.0, 6.0, 12.0, 3.5)
    assert table["enc"] == (1, 2.0, 2.0, 2.5, 2.5)
    assert table["bwd"] == (1, 6.0, 3.5, 6.0, 2.5)
    assert table["cell"] == (2, 2.5, 2.5, 3.5, 3.5)
    # a record without device ms leaves its name's device columns empty
    recs.append(SpanRecord("enc", 6, 5, 5, 21_000_000, 22_000_000))
    row = profiling.span_table(recs)["enc"]
    assert row.count == 2 and row.device_ms is None
    assert row.self_device_ms is None


def test_trace_starts_with_no_span_records(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    assert [r.name for r in profiling.span_records()][-1] == "before"
    with profiling.trace(str(tmp_path)):
        assert profiling.span_records() == []
        with profiling.span("inside"):
            pass
    assert [r.name for r in profiling.span_records()] == ["inside"]


def test_spans_on_many_threads_keep_every_record():
    # a profiler session is seen only on its own thread and the autograd
    # engine's; the bookkeeping under it is held to here directly
    n_threads, n_spans = 16, 50

    def work(k):
        for _ in range(n_spans):
            with profiling._Span(f"outer{k}"):
                with profiling._Span(f"inner{k}"):
                    pass
    profiling.clear_spans()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    records = profiling.span_records()
    assert len(records) == 2 * n_threads * n_spans
    assert len({r.id for r in records}) == len(records)
    by_id = {r.id: r for r in records}
    for r in records:
        if r.name.startswith("inner"):
            assert by_id[r.parent].name == "outer" + r.name[5:]
            assert r.top == by_id[r.parent].top
    profiling.clear_spans()


def test_span_records_keep_only_the_newest(monkeypatch):
    # a long session, or one session after another, holds at most KEEP
    # records: the newest
    monkeypatch.setattr(profiling, "_RECORDS", profiling.deque(maxlen=4))
    for session in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            for k in range(4):
                with profiling.span(f"s{session}.{k}"):
                    pass
    assert [r.name for r in profiling.span_records()] == [
        "s1.0", "s1.1", "s1.2", "s1.3"]


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.at = None

    def record(self, stream):
        self.at = stream.clock = stream.clock + 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_span_events_come_back_to_the_pool(monkeypatch):
    # with a card, each span takes two timing events from the pool;
    # span_records resolves them and returns them for the next spans
    stream = type("Stream", (), {"clock": 0})()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiling, "_EVENTS", [])
    _FakeEvent.made = 0
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass
        first = profiling.span_records()
        with profiling.span("again"):
            pass
    assert [r.device_ms for r in first] == [3.0, 1.0, 3.0, 1.0]
    assert _FakeEvent.made == 8 and len(profiling._EVENTS) == 6
    assert profiling.span_records()[-1].device_ms == 1.0
    assert _FakeEvent.made == 8 and len(profiling._EVENTS) == 8
    profiling.clear_spans()
