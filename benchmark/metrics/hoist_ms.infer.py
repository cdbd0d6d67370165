"""The S-term hoist a forward: the skips' gate convolutions and the cells'
packed weights (``_hoist_cells_rowmajor``). Device ms of the port's
``rsis.hoist`` spans in the profiled window (CUDA events at each span's
ends), summed, over the window's top-level spans
(``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.hoist", ctx)
