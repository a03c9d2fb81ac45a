"""Shared arithmetic of the readers of the program's own spans and
counters (``gloc3d_tpu_torch.profiling``'s registry).

The registry records only while a ``torch.profiler`` profile records: in a
``--trace 1`` run, exactly the traced slice. A reader takes the spans under
the cell's entry point (``locate_fused`` or ``locate_batch``, the root of
their paths) and divides by the registry's own ``<entry>.queries``. It
returns None where the registry holds no such span (a program without the
registry, or a run without a traced slice).

Only host spans are read here. The registry's device spans, read under the
profile, hold the gaps that CUPTI's kernel tracing stretches between the
captured programs' kernels, and in the eager batch the gaps in which the
device waited for the host: they are not the device's time, and no metric
reads them from the traced slice.
"""

from __future__ import annotations

from typing import Iterable, Optional


def summary() -> Optional[dict]:
    """The program's registry, or None where the program has none."""
    try:
        from gloc3d_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "summary", None)
    return read() if read is not None else None


def _paths(s: dict, entry: str, names: Iterable[str], kind: str):
    """The registry's totals of the spans ``names`` of ``kind`` under
    ``entry``."""
    names = set(names)
    out = []
    for path, total in s.get("paths", {}).items():
        parts = path.split("/")
        if parts[0] == entry and parts[-1] in names and len(parts) > 1 \
                and total["kind"] == kind:
            out.append(total)
    return out


def host_ms(ctx):
    """Host ms per query in the entry point's calls outside its ``wait``
    spans (the host reads that synchronise)."""
    s = summary()
    if not s:
        return None
    entry = ctx.cell.traffic["entry"]
    whole = s.get("paths", {}).get(entry)
    n = s.get("counters", {}).get(f"{entry}.queries", 0)
    if not whole or not n:
        return None
    waits = sum(t["ms"] for t in _paths(s, entry, ("wait",), "host"))
    return (whole["ms"] - waits) / n
