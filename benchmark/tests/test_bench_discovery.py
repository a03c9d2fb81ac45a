"""The harness finds configurations, traffic mixes, cells, limits and
per-layer metrics by name: a new cell and a new metric are new files and
new entries in BENCHMARK.json, and no existing file changes."""

import hashlib
import json
import os
import shutil

from lbench import cell, spec


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" in base or "_cache" in base:
                continue
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_new_files(tmp_path, tiny):
    root = str(tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    before = _digests(root)

    b = os.path.join(root, "benchmark")
    traffic = spec.load_json(os.path.join(b, "traffic", "relocalize.json"))
    traffic["pool"]["off_map_every"] = 2
    with open(os.path.join(b, "traffic", "fallback-heavy.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(b, "limits", "s2s-fallback-heavy.json"), "w") as f:
        f.write(open(os.path.join(
            b, "limits", "s2s-aligned-relocalize.json")).read())
    with open(os.path.join(b, "metrics", "calls.relocalize.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.units))\n")
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["workloads"].append({
        "name": "s2s-fallback-heavy", "config": "s2s-pointpillar-netvladfc",
        "traffic": "fallback-heavy", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "calls.relocalize", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "pipeline host side",
        "moves": "query_p50_ms", "workloads": ["s2s-fallback-heavy"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before

    found = spec.load_cell("s2s-fallback-heavy", root)
    assert found.traffic["pool"]["off_map_every"] == 2
    assert "calls.relocalize" in spec.readers(found, root)
    line = cell.run("s2s-fallback-heavy", 3, 0.3, True, "cpu",
                    overrides=tiny, root=root, log=lambda m: None)
    assert line["metrics"]["calls.relocalize"]["value"] > 0
    assert line["correct"]
