"""Profiling and observability.

Port of ``gloc3d_tpu/profiling.py``:

  - ``StageTimer``: named accumulating wall timers; a stage given a CUDA
    tensor as ``result_ref`` waits for the work queued before it on that
    tensor's device (a CUDA event recorded at the stage's end and
    synchronized), so the time covers the device's work and not only the
    launches.
  - ``trace``: a ``torch.profiler`` trace of the CPU and, where there is a
    card, CUDA activity, written into ``logdir`` as a Chrome trace file
    (open it in chrome://tracing or Perfetto).
  - ``MetricsLogger``: append-only JSONL metrics (step, name, value).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def _block(x) -> None:
    """Wait for the device work queued before now on the device of the
    first tensor in ``x`` (a tensor or a nest of tuples, lists and dicts);
    nothing to wait for on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        event.synchronize()


class StageTimer:
    """Accumulating per-stage wall timers (TicToc parity)."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result_ref=None):
        t0 = time.perf_counter()
        yield
        if result_ref is not None:
            _block(result_ref)
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        return self.total[name] / max(self.count[name], 1) * 1000.0

    def report(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.total}


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is there) and write ``logdir/trace.json``, a
    Chrome trace whose kernel spans carry the kernels' names. The profile
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


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def log(self, step: int, **values) -> None:
        rec = {"step": int(step)}
        for k, v in values.items():
            rec[k] = float(v) if isinstance(v, (int, float, np.floating)) else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
