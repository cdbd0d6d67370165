"""Percentage of the profiled window of train steps in which nothing ran
on the device: 1 - (union of the device intervals) / window."""


def read(ctx):
    if ctx.cell.mix["loop"] != "train":
        return None
    return ctx.idle_percent()
