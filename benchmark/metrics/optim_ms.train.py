"""The optimizer a train step: both groups' updates
(``train/optim.update_groups``). Device ms of the port's ``rsis.optim``
spans in the profiled window (CUDA events at each span's ends), summed,
over the window's top-level spans (``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.optim", ctx)
