"""The output a forward: the masks' final upsample to the frame and the
sigmoids (``models/rsis.forward``). Device ms of the port's
``rsis.output`` spans in the profiled window (CUDA events at each span's
ends), summed, over the window's top-level spans
(``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.output", ctx)
