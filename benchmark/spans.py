"""The port's spans in the profiled window, for the per-layer readers.

While a profiler session runs, the port records a span at each layer
boundary (``rsis_tpu_torch.utils.profiling.span``: ``rsis.encoder``,
``rsis.decode``, ``rsis.backward.cell``, ...), each with its host
interval on the profiler's clock and its device ms, the current stream's
time between two CUDA events at its ends. A reader keeps the records
whose host interval lies in the run's profiled window (the port may keep
records of earlier sessions too). Its number is the device ms of one
span name, summed over the window, over the window's top-level spans: a
forward (``rsis.forward``) or a train step (``rsis.train_step``). A run
without a profiled window, a port without spans, or records without
device ms (no card) give nothing.
"""

from __future__ import annotations

from collections import defaultdict

TOP = ("rsis.forward", "rsis.train_step")


def records(window=None) -> list:
    """The port's span records, those inside ``window`` (ns, the
    profiler's clock) where one is given; none where the port keeps
    none."""
    try:
        from rsis_tpu_torch.utils import profiling
        read = profiling.span_records
    except (ImportError, AttributeError):
        return []
    recs = read()
    if window is None:
        return recs
    lo, hi = window
    return [r for r in recs if lo <= r.host_start_ns and r.host_end_ns <= hi]


def ms_per_top(name: str, ctx):
    """Summed device ms of the spans called ``name`` in the run's profiled
    window over the count of its top-level spans, or None where either is
    missing."""
    trace = getattr(getattr(ctx, "outcome", None), "trace", None)
    if trace is None:
        return None
    recs = records(trace.window)
    tops = sum(1 for r in recs if r.parent is None and r.name in TOP)
    times = [r.device_ms for r in recs
             if r.name == name and r.device_ms is not None]
    if not tops or not times:
        return None
    return sum(times) / tops


def coverage(recs, window_ns: int | None = None) -> dict:
    """Each top-level span's device ms beside its direct children's sum
    and their share, with the ``rsis.backward.cell`` spans with device ms
    under it; with ``window_ns``, the top-level spans' summed device ms
    over the window's."""
    kids = defaultdict(float)
    cells = defaultdict(int)
    for r in recs:
        if r.parent is not None and r.device_ms is not None:
            kids[r.parent] += r.device_ms
        if r.name == "rsis.backward.cell" and r.device_ms is not None:
            cells[r.top] += 1
    tops = [r for r in recs if r.parent is None]
    out = {"tops": [{"name": r.name, "device_ms": r.device_ms,
                     "children_ms": kids[r.id],
                     "share": (kids[r.id] / r.device_ms
                               if r.device_ms else None),
                     "cell_backward_spans": cells[r.id]} for r in tops]}
    if window_ns:
        out["window_ms"] = window_ns / 1e6
        out["tops_over_window"] = (sum(r.device_ms or 0.0 for r in tops)
                                   / (window_ns / 1e6))
    return out
