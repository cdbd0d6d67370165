"""The decode loop a forward: the hoist, the carry and the T steps
(``decode_sequence_rowmajor``). Device ms of the port's ``rsis.decode``
spans in the profiled window (CUDA events at each span's ends), summed,
over the window's top-level spans (``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.decode", ctx)
