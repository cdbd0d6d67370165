"""All images of the measured window over the window's seconds (from its
first call to the last batch's outputs being ready)."""


def read(ctx):
    if ctx.cell.mix["loop"] != "infer":
        return None
    return ctx.outcome.images / ctx.outcome.window_s
