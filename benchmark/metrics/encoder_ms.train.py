"""The encoder's forward a train step: the backbone and the skips' casts
(``train/step._forward_with_costs``). Device ms of the port's
``rsis.encoder`` spans in the profiled window (CUDA events at each
span's ends), summed, over the window's top-level spans
(``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.encoder", ctx)
