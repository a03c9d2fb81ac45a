"""mfu.batch: The descriptor network's FLOPs per query times the window's queries, over the window's seconds, against 989 TFLOP/s bf16."""

from lbench import readers


def read(ctx):
    return readers.mfu(ctx)
