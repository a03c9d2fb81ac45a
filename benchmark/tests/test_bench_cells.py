"""Every cell end to end at a tiny size on the CPU: the port's answers
agree with the plain reference, and the result line has the contract's
keys."""

import json

import pytest

from lbench import cell, spec

CELLS = [w["name"] for w in spec.load_json(
    f"{spec.ROOT}/BENCHMARK.json")["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name, tiny):
    line = cell.run(name, 2 ** 31 + 11, 0.5, False, "cpu", overrides=tiny,
                    log=lambda m: None)
    bad = {k: v for k, v in line["check"].items()
           if v["value"] > v["limit"]}
    assert line["correct"], bad
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line) == KEYS + ["check"]
    want = {m["name"] for m in spec.load_cell(name).end_to_end}
    assert set(line["metrics"]) == want
    assert json.loads(json.dumps(line)) == line


def test_traced_line(tiny):
    name = "s2s-aligned-relocalize"
    line = cell.run(name, 5, 0.3, True, "cpu", overrides=tiny,
                    log=lambda m: None)
    assert list(line) == KEYS + ["breakdown", "check"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    # on the CPU no device operation is traced: the readers of the trace
    # return nothing and their metrics are left out; the others read
    assert "mfu.relocalize" in line["metrics"]
    assert "stage2_share.relocalize" in line["metrics"]
    assert "fft_ms.relocalize" in line["metrics"]  # 0 ms: none ran
    assert "device_idle_share.relocalize" not in line["metrics"]
    assert "k2_roofline.relocalize" not in line["metrics"]
