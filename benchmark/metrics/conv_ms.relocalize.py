"""conv_ms.relocalize: Device ms of convolution kernels per query in the traced slice (naming rule in lbench/readers.py)."""

from lbench import readers


def read(ctx):
    return readers.ms_per_query(ctx, readers.is_conv)
