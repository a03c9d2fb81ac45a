"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``). A
reader returns None where its run has nothing to read, and the harness
then leaves its metric out of the line.

Kernel naming rules (the trace's kernel names):

- cuFFT: the name holds ``fft`` (``regular_fft``, ``vector_fft``, ...;
  not cub's ``DeviceRadixSort``);
- convolution: the name holds ``fprop``, ``conv``, ``implicit_gemm`` or
  ``winograd`` (cuDNN's and CUTLASS's forward-convolution kernels), not
  the layout transforms around them;
- K2: the name holds ``pillar_bin_sums`` (its four kernels).
"""

from __future__ import annotations

from lbench import flops


def is_fft(name: str) -> bool:
    return "fft" in name.lower()


def is_conv(name: str) -> bool:
    n = name.lower()
    return any(k in n for k in ("fprop", "conv", "implicit_gemm",
                                "winograd"))


def is_k2(name: str) -> bool:
    return "pillar_bin_sums" in name


def ms_per_query(ctx, pick):
    if not ctx.traced_queries:
        return None
    return ctx.device_ms(pick) / ctx.traced_queries


def syncs_per_query(ctx):
    if not ctx.sync_queries:
        return None
    return ctx.syncs / ctx.sync_queries


def stage2_share(ctx):
    """% of the window's queries whose top candidate did not register."""
    if not ctx.answers:
        return None
    missed = sum(not a.success or a.db_index != int(a.candidates[0])
                 for a in ctx.answers)
    return 100.0 * missed / len(ctx.answers)


def k2_roofline(ctx):
    """% of K2's bound (its bytes at HBM peak) that its traced time
    reaches."""
    ms = ctx.device_ms(is_k2) if ctx.slice else 0.0
    if not ms or not ctx.traced_queries:
        return None
    bound_ms = (ctx.k2_bytes_per_query * ctx.traced_queries
                / flops.HBM_BYTES_PER_S * 1e3)
    return 100.0 * bound_ms / ms


def mfu(ctx):
    """% of the card's bf16 peak: the descriptor network's FLOPs of every
    query of the window over the window's seconds."""
    if not ctx.queries or ctx.window_s <= 0:
        return None
    return (100.0 * ctx.flops_per_query * ctx.queries / ctx.window_s
            / flops.PEAK_BF16_FLOPS)


def device_idle_share(ctx):
    sl = ctx.slice
    if sl is None or sl.wall_s <= 0 or not sl.ops:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)
