"""stage2_share.relocalize: % of the window's queries whose top-ranked
candidate did not register (not a success, or another keyframe returned),
so that stage 2 ran."""

from lbench import readers


def read(ctx):
    return readers.stage2_share(ctx)
