"""fft_ms.relocalize: Device ms of cuFFT kernels per query in the traced slice."""

from lbench import readers


def read(ctx):
    return readers.ms_per_query(ctx, readers.is_fft)
