"""host_ms.batch: Host ms per query in ``locate_batch`` outside its ``wait`` spans (the host reads that synchronise), over the registry's queries of the traced slice."""

from lbench import spans


def read(ctx):
    return spans.host_ms(ctx)
