"""The port's profiling module (``gloc3d_tpu_torch/profiling.py``):
counterparts of tests/test_profiling.py's StageTimer, MetricsLogger and
profiler-trace tests, on the CPU."""

import json
import os

import torch

from gloc3d_tpu_torch.profiling import TRACE_FILE, MetricsLogger, StageTimer
from gloc3d_tpu_torch.profiling import trace
from test_torch_threads import _two_threads  # noqa: F401


def test_stage_timer():
    t = StageTimer()
    x = torch.ones((128, 128))
    with t.stage("matmul", result_ref=None):
        y = x @ x
    with t.stage("matmul", result_ref=y):
        y = x @ x
    assert t.count["matmul"] == 2
    assert t.mean_ms("matmul") >= 0
    assert "matmul" in t.report()


def test_stage_timer_takes_nested_results():
    """``result_ref`` may be a tuple, list or dict of tensors (a
    localizer's outputs), or hold none."""
    t = StageTimer()
    x = torch.ones((8, 8))
    for ref in ((x, None), [None, {"a": x}], {"k": 3}, ()):
        with t.stage("nested", result_ref=ref):
            pass
    assert t.count["nested"] == 4
    assert set(t.report()) == {"nested"}


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "metrics.jsonl")
    m = MetricsLogger(p)
    m.log(1, loss=0.5, recall={"1": 0.9})
    m.log(2, loss=0.4)
    m.close()
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]["loss"] == 0.5
    assert lines[0]["recall"] == {"1": 0.9}
    assert lines[1]["step"] == 2


def test_profiler_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        x = torch.ones((64, 64))
        (x @ x).sum().item()
    path = os.path.join(logdir, TRACE_FILE)
    assert os.path.exists(path), "no profiler trace file written"
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
