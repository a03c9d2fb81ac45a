"""k2_roofline.relocalize: K2's share of its roofline: its two binnings' bytes per scan (inputs read once, outputs written once, from the op's shapes) at 3.35 TB/s over the traced time of the pillar_bin_sums kernels."""

from lbench import readers


def read(ctx):
    return readers.k2_roofline(ctx)
