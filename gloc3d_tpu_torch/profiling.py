"""Profiling and observability: the port's one tracing system.

Port of ``gloc3d_tpu/profiling.py``, grown into one process-wide registry
of spans and counters (the reference's ``TicToc`` timers, by name):

  - The registry records only while a ``torch.profiler`` profile records
    (a ``trace`` below, or any other profile) or within ``record()``: each
    span reads the flag torch sets for a profile and the registry's own,
    and with neither set records nothing. A span never synchronises the
    device. Under a profile, CUPTI stretches the device's gaps between
    kernels, and the device spans hold those gaps; within ``record()``
    alone they read what the device takes without a profiler.
  - ``span(name)``: a host span. It opens ``torch.profiler.
    record_function(name)``, so that the profiler's trace shows it as a
    ``user_annotation`` on the clock of the device's kernels, and adds its
    ``perf_counter`` time to the registry under its path (the names of the
    spans it is nested in, then its own). ``entry(name, queries)`` is an
    entry point's outermost span: it numbers the call (the number rides in
    the span's ``record_function`` args: its ``<name>.calls`` counter) and
    counts ``<name>.calls`` and ``<name>.queries``.
  - ``device_span(name, device)``: a device range bracketed by CUDA timing
    events. Within ``graph_marks()`` (a CUDA-graph capture) it records
    external events always, and the capture keeps them: each replay
    records them again, and ``read_marks`` adds their times after a host
    read the call makes anyway. Outside a capture it records events only
    while the registry records, and the entry point's outermost span reads
    them when it closes, after the call's last host read. On the CPU it
    times the range on the host. Device spans do not nest: their sum is the
    device time they cover (in the eager batch, with the gaps in which the
    device waited for the host's launches).
  - ``count(name, n)``: counters bumped at the source while the registry
    records; ``count_capture()`` counts CUDA-graph captures always, so that
    a rise after set-up shows a call that captured its programs again.
  - ``to_host(t)``: ``t.cpu()`` inside a ``wait`` span (on a card, a host
    synchronisation).
  - ``summary()`` and ``reset()``: the registry's totals (count, ms, host
    or device, per name and per path), its counters and the kernels'
    launch counters; and a cleared registry. It keeps totals, not spans.
  - ``record()``: the registry records within the block without a profile.
  - ``trace``: a ``torch.profiler`` trace of the CPU and, where there is a
    card, CUDA activity, written into ``logdir`` as a Chrome trace file
    (open it in chrome://tracing or Perfetto); the registry records
    within it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


class _Registry:
    """Totals by span path, counters, the current path, and the device
    spans of the current call that await its last host read."""

    def __init__(self):
        self.path: Tuple[str, ...] = ()
        self.marks: Optional[list] = None  # the capture's, in graph_marks
        self.on = 0  # depth of record()
        self.reset()

    def reset(self) -> None:
        self.spans: Dict[Tuple[str, ...], list] = {}  # [count, s, kind]
        self.counters: Dict[str, int] = defaultdict(int)
        self.pending: List[tuple] = []  # (path, start event, end event)

    def add(self, path: Tuple[str, ...], seconds: float, kind: str) -> None:
        total = self.spans.get(path)
        if total is None:
            self.spans[path] = [1, seconds, kind]
        else:
            total[0] += 1
            total[1] += seconds

    def collect(self, keep: bool) -> None:
        """The pending device spans' times (their events have completed:
        the call has read the device since), or, after a failed call,
        none."""
        pending, self.pending = self.pending, []
        for path, start, end in pending:
            if keep and end.query():
                self.add(path, start.elapsed_time(end) / 1e3, "device")


_REG = _Registry()


def _recording() -> bool:
    return _autograd_profiler._is_profiler_enabled or _REG.on > 0


class _HostSpan:
    __slots__ = ("name", "args", "outer", "rf", "t0")

    def __init__(self, name: str, args: Optional[str] = None):
        self.name, self.args = name, args

    def __enter__(self):
        self.outer = _REG.path
        _REG.path = self.outer + (self.name,)
        self.rf = torch.profiler.record_function(self.name, self.args)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        seconds = time.perf_counter() - self.t0
        self.rf.__exit__(exc_type, exc, tb)
        _REG.add(_REG.path, seconds, "host")
        _REG.path = self.outer
        if not self.outer:
            _REG.collect(keep=exc_type is None)
        return False


class _HostTimedDeviceSpan:
    """A device span on the CPU: the range's host time."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        _REG.add(_REG.path + (self.name,), time.perf_counter() - self.t0,
                 "device")
        return False


class _EventSpan:
    """A device span on a card: timing events on the current stream,
    read when the outermost span closes (or, captured, by
    ``read_marks``)."""

    __slots__ = ("name", "marks", "start")

    def __init__(self, name: str, marks: Optional[list] = None):
        self.name, self.marks = name, marks

    def _event(self):
        if self.marks is None:
            return torch.cuda.Event(enable_timing=True)
        return torch.cuda.Event(enable_timing=True, external=True)

    def __enter__(self):
        self.start = self._event()
        self.start.record()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = self._event()
        end.record()
        if self.marks is not None:
            self.marks.append((self.name, self.start, end))
        else:
            _REG.pending.append((_REG.path + (self.name,), self.start, end))
        return False


def span(name: str):
    """A host span named ``name`` (a null context while nothing records)."""
    if not _recording():
        return _NULL
    return _HostSpan(name)


def entry(name: str, queries: int):
    """The outermost span of a call of the entry point ``name`` with
    ``queries`` queries: numbered (``call <n>`` in its record_function
    args), and counted in ``<name>.calls`` and ``<name>.queries``."""
    if not _recording():
        return _NULL
    counters = _REG.counters
    counters[name + ".calls"] += 1
    counters[name + ".queries"] += int(queries)
    return _HostSpan(name, f"call {counters[name + '.calls']}")


def device_span(name: str, device: torch.device):
    """A device span named ``name`` of work queued on ``device``'s current
    stream (see the module's docstring)."""
    if _REG.marks is not None:
        return _EventSpan(name, _REG.marks)
    if not _recording():
        return _NULL
    if device.type == "cuda":
        return _EventSpan(name)
    return _HostTimedDeviceSpan(name)


@contextlib.contextmanager
def graph_marks():
    """Around a CUDA-graph capture: the device spans captured within, as
    the list this yields of (name, start, end) external events, which the
    graph's owner keeps alive with it and gives to ``read_marks``."""
    outer, _REG.marks = _REG.marks, []
    try:
        yield _REG.marks
    finally:
        _REG.marks = outer


def read_marks(marks) -> None:
    """Add the captured device spans' times of the graph's last replay,
    under the current entry point's ``replay``, while the registry
    records; call it only after a host read that followed the replay."""
    if not _recording():
        return
    root = _REG.path[:1] + ("replay",)
    for name, start, end in marks:
        _REG.add(root + (name,), start.elapsed_time(end) / 1e3, "device")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the registry records."""
    if _recording():
        _REG.counters[name] += int(n)


def count_capture() -> None:
    """Count one CUDA-graph capture (always: captures are rare)."""
    _REG.counters["captures"] += 1


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()`` inside a ``wait`` span: on a card, a host
    synchronisation, counted where it is made."""
    if not _recording():
        return t.cpu()
    with _HostSpan("wait"):
        return t.cpu()


def _kernel_counts() -> dict:
    """K1's and K2's launch counters, read where they live."""
    from gloc3d_tpu_torch.kernels import bin_sums, segment_sum

    return {name: {f: getattr(fn, f) for f in ("launches", "captured",
                                                "replayed")}
            for name, fn in (("k1", segment_sum.segment_sum_sorted),
                             ("k2", bin_sums.pillar_bin_sums))}


def _totals(items) -> dict:
    return {"count": items[0], "ms": items[1] * 1e3, "kind": items[2]}


def summary() -> dict:
    """The registry: ``spans`` per name and ``paths`` per path (``a/b/c``)
    with their count, total ms and kind (``host`` or ``device``); the
    ``counters`` (``captures`` always); the kernels' launch counters."""
    by_name: Dict[str, list] = {}
    for path, (n, seconds, kind) in _REG.spans.items():
        total = by_name.setdefault(path[-1], [0, 0.0, kind])
        total[0] += n
        total[1] += seconds
    counters = dict(_REG.counters)
    counters.setdefault("captures", 0)
    return {"spans": {k: _totals(v) for k, v in by_name.items()},
            "paths": {"/".join(p): _totals(v) for p, v in _REG.spans.items()},
            "counters": counters, "kernels": _kernel_counts()}


def reset() -> None:
    """Clear the registry's totals, counters and pending spans."""
    _REG.reset()


@contextlib.contextmanager
def record():
    """Let the registry record within the block with no profile running:
    the device spans then read the device's own time, without the gaps
    that CUPTI's kernel tracing adds under a profile. The host spans still
    open their ``record_function``, which records nothing without a
    profile."""
    _REG.on += 1
    try:
        yield
    finally:
        _REG.on -= 1


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is there) and write ``logdir/trace.json``, a
    Chrome trace whose kernel spans carry the kernels' names and whose
    ``user_annotation`` events are the registry's host spans. The profile
    itself is yielded, for ``key_averages()`` and the like."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
