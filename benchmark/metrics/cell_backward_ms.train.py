"""The cells' backward a train step: K4, K5 and K3 with the pullback's
glue, five a decode step (``FusedCellFunction.backward``). Device ms of
the port's ``rsis.backward.cell`` spans in the profiled window (CUDA
events at each span's ends), summed, over the window's top-level spans
(``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.backward.cell", ctx)
