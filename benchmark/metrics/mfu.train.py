"""Model operations of the images the window's train steps took (the
forward and the backward the update needs), over the window's seconds,
as a percentage of the peak of the configuration's precision (bf16
989 TFLOP/s, fp32 against TF32's 495)."""


def read(ctx):
    if ctx.cell.mix["loop"] != "train":
        return None
    return ctx.mfu_percent()
