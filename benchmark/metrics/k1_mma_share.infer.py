"""The share of K1's launches (the decode cell, ``csrc/fused_cell.cu``)
that took the staged tensor-core loop, in percent: the port's own
counters, ``fused_cell_rowmajor.mma_launches`` over
``fused_cell_rowmajor.launches``, read directly since the process
started (the set-up, the window and the profiled window run the same
shapes). None where the port keeps no such counter or K1 never ran."""


def read(ctx):
    if ctx.cell.mix["loop"] != "infer":
        return None
    try:
        from rsis_tpu_torch.ops.fused_cell import fused_cell_rowmajor as k1
        mma, calls = int(k1.mma_launches), int(k1.launches)
    except (ImportError, AttributeError):
        return None
    return 100.0 * mma / calls if calls else None
