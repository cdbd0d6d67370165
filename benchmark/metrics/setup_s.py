"""Seconds from the process's start to the first timed call: imports,
the port's kernel libraries, weights, inputs and the warm-up of the
cell's own shapes (the train cells' checked steps among them)."""


def read(ctx):
    return ctx.outcome.setup_s
