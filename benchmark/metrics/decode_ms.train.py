"""The decode loop's forward a train step: the hoist, the carry, the T
steps and their cost columns. Device ms of the port's ``rsis.decode``
spans in the profiled window (CUDA events at each span's ends), summed,
over the window's top-level spans (``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.decode", ctx)
