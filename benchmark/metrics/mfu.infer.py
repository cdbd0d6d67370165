"""Model operations of the images the window's forwards finished, over
the window's seconds, as a percentage of the peak of the configuration's
precision (``counts/``)."""


def read(ctx):
    if ctx.cell.mix["loop"] != "infer":
        return None
    return ctx.mfu_percent()
