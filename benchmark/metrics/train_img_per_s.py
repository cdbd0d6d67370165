"""All images the window's train steps took over the window's seconds
(from the first step's call to the last step's metrics on the host)."""


def read(ctx):
    if ctx.cell.mix["loop"] != "train":
        return None
    return ctx.outcome.images / ctx.outcome.window_s
