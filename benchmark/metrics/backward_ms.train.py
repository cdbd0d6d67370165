"""The backward a train step: ``torch.autograd.grad`` over every parameter.
Device ms of the port's ``rsis.backward`` spans in the profiled window
(CUDA events at each span's ends), summed, over the window's top-level
spans (``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.backward", ctx)
