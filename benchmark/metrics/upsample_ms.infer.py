"""The inter-cell upsamples a forward: four a decode step, each two fp32
interpolation products (``_upsample_rowmajor``). Device ms of the port's
``rsis.decode.upsample`` spans in the profiled window (CUDA events at
each span's ends), summed, over the window's top-level spans
(``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.decode.upsample", ctx)
