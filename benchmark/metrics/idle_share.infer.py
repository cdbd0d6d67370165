"""Percentage of the profiled window of forwards in which nothing ran on
the device: 1 - (union of the device intervals) / window."""


def read(ctx):
    if ctx.cell.mix["loop"] != "infer":
        return None
    return ctx.idle_percent()
