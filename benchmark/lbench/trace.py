"""A bounded, steady slice of the window traced with ``torch.profiler``,
reduced in memory to what the per-layer metrics read: the device
operations (kernels, copies, fills) with their names and times, the
device's busy time as the union of their intervals, the idle gaps labelled
by what the host was doing, and the host synchronisations of a further
slice counted with ``torch.cuda.set_sync_debug_mode``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from collections import defaultdict
from typing import Callable, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Op(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class Slice(NamedTuple):
    ops: List[Op]                     # device operations
    busy_s: float                     # union of their intervals
    wall_s: float                     # host clock over the slice
    gaps: List[Tuple[str, float]]     # (host activity, idle seconds)
    units: int                        # queries run in the slice


def _events(prof) -> list:
    """The chrome-trace events of a finished profile; the file is read
    back and removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(spans) -> Tuple[float, list]:
    """Busy microseconds of sorted (start, end) spans, and the idle gaps
    between them as (start, end)."""
    busy, end, gaps = 0.0, None, []
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    return busy, gaps


def _labels(gaps, host, n: int = 300):
    """(label, idle seconds) of the ``n`` longest gaps, each labelled by
    the innermost host event that covers its middle; the shorter gaps
    together under one label."""
    import numpy as np

    names = [h[0] for h in host]
    a = np.array([h[1] for h in host]) if host else np.zeros(0)
    b = np.array([h[2] for h in host]) if host else np.zeros(0)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:n]:
        mid = (g0 + g1) / 2.0
        cover = np.flatnonzero((a <= mid) & (b >= mid))
        name = (names[cover[np.argmin(b[cover] - a[cover])]] if cover.size
                else "host outside torch")
        out.append((name, (g1 - g0) / 1e6))
    rest = sum(g1 - g0 for g0, g1 in gaps[n:]) / 1e6
    if rest:
        out.append((f"gaps shorter than the {n} longest", rest))
    return out


def traced(torch, run_units: Callable[[], int], cuda: bool = True) -> Slice:
    """Profile ``run_units()`` (which runs the slice and returns how many
    calls it made) after a device synchronisation on both sides (the
    host's activity alone without a card)."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        units = run_units()
        sync()
        wall = time.perf_counter() - t0
    events = _events(prof)
    ops = sorted((Op(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)))
                  for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda o: o.start_us)
    busy, gaps = _union((o.start_us, o.start_us + o.dur_us) for o in ops)
    host = [(e.get("name", ""), float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0))) for e in events
            if e.get("cat") in HOST_CATS and "ts" in e]
    by_label = defaultdict(float)
    for name, seconds in _labels(gaps, host):
        by_label[name] += seconds
    return Slice(ops, busy / 1e6, wall, sorted(by_label.items(),
                                               key=lambda kv: -kv[1]), units)


def count_syncs(torch, run_units: Callable[[], int],
                cuda: bool = True) -> Tuple[int, int]:
    """(host synchronisations, calls) of ``run_units()``, as
    ``set_sync_debug_mode("warn")`` reports them (not counting the mode's
    own notice that it is a prototype); none without a card."""
    if not cuda:
        return 0, run_units()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            units = run_units()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in caught), units


def by_name(sl: Slice) -> List[Tuple[str, float, int]]:
    """(name, device ms, count) of the slice's operations, longest first."""
    ms, n = defaultdict(float), defaultdict(int)
    for o in sl.ops:
        ms[o.name] += o.dur_us / 1e3
        n[o.name] += 1
    return sorted(((k, v, n[k]) for k, v in ms.items()), key=lambda r: -r[1])


def breakdown(sl: Slice) -> dict:
    """The ten device operations that took the most time (by name) and the
    ten host activities under which the device idled longest."""
    by_name = defaultdict(float)
    for o in sl.ops:
        by_name[o.name[:160]] += o.dur_us / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k[:160], v] for k, v in sl.gaps[:10]]}
