"""The matcher a train step: the costs' masking, the LAP (K6), the
permutation and the GT gather (``train/step._losses``). Device ms of the
port's ``rsis.match`` spans in the profiled window (CUDA events at each
span's ends), summed, over the window's top-level spans
(``benchmark/spans.py``)."""

from benchmark.spans import ms_per_top


def read(ctx):
    return ms_per_top("rsis.match", ctx)
