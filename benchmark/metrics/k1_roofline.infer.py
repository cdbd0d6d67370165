"""K1 (the decode cell, ``csrc/fused_cell.cu``) in the profiled forwards:
the launches' summed bound over their summed device time, in percent.
The port counts K1's calls (``fused_cell_rowmajor.launches``); each
decode step makes five, one a cell, so the bound is (calls / 5) decode
steps of ``counts/kernels.step_bound_s``."""


def read(ctx):
    if ctx.cell.mix["loop"] != "infer":
        return None
    return ctx.roofline_percent("k1", "k1_launches", ("LstmForward",))
