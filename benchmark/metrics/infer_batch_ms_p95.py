"""The 95th percentile of every batch of the window, each timed from its
call to its outputs being ready, in milliseconds (linear interpolation
between order statistics)."""

import numpy as np


def read(ctx):
    batches = ctx.outcome.spans.get("batch")
    if ctx.cell.mix["loop"] != "infer" or not batches:
        return None
    return 1e3 * float(np.percentile(batches, 95))
