"""The readers of the program's own spans and counters
(``lbench/spans.py``, ``metrics/<name>.py``): a traced run of a tiny cell
on the CPU gives each of its span metrics a finite number, and a registry
with nothing in it, or a program without one, gives None."""

import math
import types

import pytest

from lbench import cell, spec

SPAN_METRICS = {
    "s2s-aligned-relocalize": ["host_ms.relocalize"],
    "i2i-aligned-batch8": ["host_ms.batch"],
}


def _per_layer(name):
    return {m["name"] for m in spec.load_cell(name).per_layer}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_the_cells_list_their_span_metrics(name):
    assert set(SPAN_METRICS[name]) <= _per_layer(name)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_traced_run_reads_every_span_metric(name, tiny):
    from gloc3d_tpu_torch import profiling

    # four relocalize calls put an off-map query (every fourth place) and
    # so stage 2 into the traced slice
    over = dict(tiny, traffic=dict(tiny["traffic"], trace_units=4))
    profiling.reset()
    line = cell.run(name, 2 ** 31 + 23, 0.3, True, "cpu", overrides=over,
                    log=lambda m: None)
    profiling.reset()
    assert line["correct"]
    for metric in SPAN_METRICS[name]:
        value = line["metrics"][metric]["value"]
        assert math.isfinite(value) and value >= 0, (metric, value)


def _ctx(name):
    return types.SimpleNamespace(cell=spec.load_cell(name))


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_an_empty_registry_gives_none(name):
    from gloc3d_tpu_torch import profiling

    profiling.reset()
    for metric in SPAN_METRICS[name]:
        assert spec.metric_reader(metric)(_ctx(name)) is None


def test_a_program_without_the_registry_gives_none(monkeypatch):
    from gloc3d_tpu_torch import profiling

    monkeypatch.delattr(profiling, "summary")
    for name, metrics in SPAN_METRICS.items():
        for metric in metrics:
            assert spec.metric_reader(metric)(_ctx(name)) is None
