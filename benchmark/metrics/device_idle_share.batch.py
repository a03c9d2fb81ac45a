"""device_idle_share.batch: % of the traced slice's wall time in which no kernel, copy or fill ran."""

from lbench import readers


def read(ctx):
    return readers.device_idle_share(ctx)
