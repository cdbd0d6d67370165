"""Profiling: torch.profiler traces, step timing, the port's spans, and
trace analysis.

Counterpart of ``rsis_tpu/utils/profiling.py`` for the port: a trace is
one context manager away, and the analysis over it (nesting-aware self
times by operation name) is library code:

    with trace("build/tr"):
        step(...)                  # the trace waits for the card
    for row in op_table(load_trace_events("build/tr")):
        print(row)

``trace`` records CPU activity and, when there is a card, CUDA activity,
and writes one Chrome trace (``<time>.pt.trace.json``) into its
directory. The tables read any Chrome/Perfetto trace: by default the
device kernels (events of category ``kernel``, as torch's traces mark
them), or the threads whose name holds a given lane (the JAX package's
``"XLA Ops"``), or every thread with ``lane=None``.

Spans: the forward and the train step mark their layers with
``span(name)`` (``rsis.encoder``, ``rsis.decode``, ``rsis.backward``,
...). A span records only while a ``torch.profiler`` session runs (any
session: ``trace`` or the caller's own); otherwise it costs one check.
While one runs, a span is a ``record_function`` range on the profiler's
host timeline (which the profiler mirrors on the device's), a pair of
timing CUDA events on the current stream (taken from a pool that
``span_records`` refills), and a ``SpanRecord``; the newest ``KEEP``
records are kept until the next ``trace`` starts:

    with trace("build/tr"):
        step(...)
    for name, row in span_table(span_records()).items():
        print(name, row)
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import (Deque, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence)

import torch

KERNELS = "kernel"   # the category of device kernels in torch's traces


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block into ``logdir``: CPU
    activity, and CUDA activity when a card is there (the card is
    synchronised before the trace stops). The span records start empty:
    ``span_records()`` afterwards holds the block's."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"{time.time_ns()}.pt.trace.json"))


@dataclass
class SpanRecord:
    """One span: its name, id, the id of the span it ran inside (None at
    the top level) and of its top-level span, its host interval (ns, the
    clock of the profiler's events) and its device ms (the stream's time
    from the start marker to the end marker; None without CUDA, or until
    ``span_records`` resolves it)."""
    name: str
    id: int
    parent: Optional[int]
    top: int
    host_start_ns: int
    host_end_ns: int
    device_ms: Optional[float] = None
    events: Optional[tuple] = None


KEEP = 1 << 14                     # the newest spans kept, across sessions
_RECORDS: Deque[SpanRecord] = deque(maxlen=KEEP)
_OPEN: Dict[int, list] = {}        # thread ident -> its open spans
_IDS = itertools.count()
_OFF = contextlib.nullcontext()
_EVENTS: List = []                 # timing events free for another span


def _event():
    try:
        return _EVENTS.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "id", "parent", "top", "start", "stream", "event",
                 "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _OPEN.setdefault(threading.get_ident(), [])
        # the autograd engine's device threads open spans with none of
        # their own open: those nest in the innermost span of any thread
        outer = stack[-1] if stack else max(
            (s[-1] for s in list(_OPEN.values()) if s),
            key=lambda sp: sp.start, default=None)
        self.range = torch.profiler.record_function(self.name)
        # the range takes its own time stamp about halfway through
        before = time.time_ns()
        self.range.__enter__()
        self.start = (before + time.time_ns()) // 2
        self.id = next(_IDS)
        self.parent = None if outer is None else outer.id
        self.top = self.id if outer is None else outer.top
        self.stream = self.event = None
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.event = _event()
            self.event.record(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        events = None
        if self.event is not None:
            events = (self.event, _event())
            events[1].record(self.stream)
        self.range.__exit__(*exc)
        _RECORDS.append(SpanRecord(self.name, self.id, self.parent, self.top,
                                   self.start, time.time_ns(),
                                   events=events))
        _OPEN[threading.get_ident()].pop()
        return False


def span(name: str):
    """A context marking one layer of the program. Without a profiler
    session it is a shared no-op context (one check of the profiler's
    state); under one, see the module's docstring."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def clear_spans() -> None:
    _RECORDS.clear()


def span_records() -> List[SpanRecord]:
    """The spans kept (those since the last ``trace`` started, the newest
    ``KEEP`` of them), in the order they opened, each with its device ms
    (waits for the card). Their events go back to the pool."""
    for r in _RECORDS:
        if r.events is not None:
            r.events[1].synchronize()
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            _EVENTS.extend(r.events)
            r.events = None
    return sorted(_RECORDS, key=lambda r: r.id)


class SpanRow(NamedTuple):
    count: int
    host_ms: float
    self_host_ms: float
    device_ms: Optional[float]
    self_device_ms: Optional[float]


def span_table(records: Sequence[SpanRecord]) -> Dict[str, SpanRow]:
    """By span name: the count, host ms, device ms, and each less its
    direct children's (self time). Device columns are None where a
    record of the name has no device ms."""
    child_host: Dict[int, float] = defaultdict(float)
    child_dev: Dict[int, float] = defaultdict(float)
    for r in records:
        if r.parent is not None:
            child_host[r.parent] += (r.host_end_ns - r.host_start_ns) / 1e6
            child_dev[r.parent] += r.device_ms or 0.0
    rows: Dict[str, list] = {}
    for r in records:
        row = rows.setdefault(r.name, [0, 0.0, 0.0, 0.0, 0.0])
        host = (r.host_end_ns - r.host_start_ns) / 1e6
        row[0] += 1
        row[1] += host
        row[2] += host - child_host[r.id]
        if r.device_ms is None or row[3] is None:
            row[3] = row[4] = None
        else:
            row[3] += r.device_ms
            row[4] += r.device_ms - child_dev[r.id]
    return {name: SpanRow(*row) for name, row in rows.items()}


@contextlib.contextmanager
def step_timer(sink=None, device=None):
    """Wall-clock a region; appends seconds to ``sink``. With a CUDA
    ``device`` the card is synchronised before the clock starts and
    before it stops, so the region's queued work is counted."""
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - start
    if sink is not None:
        sink.append(dt)


def find_trace_files(logdir: str) -> list[str]:
    """All Chrome trace files under a directory: torch's
    ``*.pt.trace.json(.gz)`` and jax.profiler's ``*.trace.json(.gz)``."""
    pats = ["**/*.trace.json.gz", "**/*.trace.json", "**/trace.json.gz",
            "**/trace.json"]
    out: list[str] = []
    for p in pats:
        out += glob.glob(os.path.join(logdir, p), recursive=True)
    return sorted(set(out))


def load_trace_events(logdir_or_file: str) -> list[dict]:
    """Complete ('X'-phase) events plus thread/process metadata ('M')
    from a trace file, or from the last (by name: the newest) trace in a
    directory. The 'M' rows stay: the lane filter resolves thread names
    through them."""
    if os.path.isdir(logdir_or_file):
        files = find_trace_files(logdir_or_file)
        if not files:
            raise FileNotFoundError(
                f"no trace.json(.gz) under {logdir_or_file}")
        path = files[-1]
    else:
        path = logdir_or_file
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fp:
        doc = json.load(fp)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events
            if (e.get("ph") == "X" and "dur" in e) or e.get("ph") == "M"]


def _lane_tids(events: Iterable[dict], lane: str) -> set:
    """(pid, tid) pairs whose thread_name metadata contains ``lane``."""
    tids = set()
    for e in events:
        if (e.get("ph") == "M" and e.get("name") == "thread_name"
                and lane in str(e.get("args", {}).get("name", ""))):
            tids.add((e.get("pid"), e.get("tid")))
    return tids


def _in_lane(events: Sequence[dict], complete: list, lane: str) -> list:
    """The complete events of ``lane``: those of that category, else
    those on threads whose name holds it, else all (a plain trace)."""
    by_cat = [e for e in complete if e.get("cat") == lane]
    if by_cat:
        return by_cat
    tids = _lane_tids(events, lane)
    if tids:
        return [e for e in complete if (e.get("pid"), e.get("tid")) in tids]
    return complete


def self_times(events: Sequence[dict], lane: str | None = KERNELS
               ) -> dict[str, float]:
    """Self time (microseconds) by event name, nesting subtracted.

    Events on one thread nest by time containment; for each event the
    durations of its immediate children are subtracted before it is
    added under its name, so a parent and its children are not counted
    twice. ``lane``: a category or a thread-name substring to keep
    (None: every thread)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if lane is not None:
        complete = _in_lane(events, complete, lane)
    by_thread: dict = defaultdict(list)
    for e in complete:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)

    out: dict[str, float] = defaultdict(float)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[tuple[float, float, str, float]] = []  # ts, end, name, child_dur
        for e in evs:
            ts, dur = float(e["ts"]), float(e["dur"])
            end = ts + dur
            while stack and ts >= stack[-1][1] - 1e-9:
                p_ts, p_end, p_name, p_child = stack.pop()
                out[p_name] += (p_end - p_ts) - p_child
                if stack:
                    s = stack[-1]
                    stack[-1] = (s[0], s[1], s[2], s[3] + (p_end - p_ts))
            stack.append((ts, end, e["name"], 0.0))
        while stack:
            p_ts, p_end, p_name, p_child = stack.pop()
            out[p_name] += (p_end - p_ts) - p_child
            if stack:
                s = stack[-1]
                stack[-1] = (s[0], s[1], s[2], s[3] + (p_end - p_ts))
    return dict(out)


def op_table(events: Sequence[dict], lane: str | None = KERNELS,
             top: int = 25, group=None) -> list[tuple[str, float]]:
    """Top-N (name, self-ms) rows, optionally regrouped by ``group(name)``
    (e.g. ``lambda n: n.split('<')[0]`` to merge a kernel's template
    instances)."""
    times = self_times(events, lane)
    if group is not None:
        merged: dict[str, float] = defaultdict(float)
        for name, us in times.items():
            merged[group(name)] += us
        times = dict(merged)
    rows = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    return [(name, us / 1e3) for name, us in rows]


def print_op_table(logdir: str, lane: str | None = KERNELS,
                   top: int = 25) -> None:
    rows = op_table(load_trace_events(logdir), lane=lane, top=top)
    width = max((len(n) for n, _ in rows), default=4)
    total = sum(ms for _, ms in rows)
    for name, ms in rows:
        print(f"{name:<{width}}  {ms:10.3f} ms")
    print(f"{'TOTAL (top ' + str(len(rows)) + ')':<{width}}  "
          f"{total:10.3f} ms")
