"""K4 (the cell backward's gate gradient, ``csrc/cell_bwd.cu``) in the
profiled train steps: the launches' summed bound over their summed
device time, in percent, as ``k1_roofline.infer`` reads K1 (calls from
``cell_backward_dgates.launches``, five a decode step)."""


def read(ctx):
    if ctx.cell.mix["loop"] != "train":
        return None
    return ctx.roofline_percent("k4", "k4_launches", ("LstmBackward",))
