"""syncs_per_query.batch: Host synchronisations per query, counted by torch.cuda.set_sync_debug_mode over the sync slice."""

from lbench import readers


def read(ctx):
    return readers.syncs_per_query(ctx)
