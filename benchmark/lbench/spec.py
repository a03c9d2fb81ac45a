"""Where the benchmark's parts live, found by the names in
``BENCHMARK.json``: a configuration's file is named in its entry, a
traffic mix is ``traffic/<traffic>.json``, a cell's limits are
``limits/<cell>.json`` and a per-layer metric's reader is
``metrics/<metric>.py``, all under the benchmark's directory. Adding any of
them is adding files.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    config: dict          # the configuration file, parsed
    traffic: dict         # the traffic mix, parsed
    limits: dict          # number compared → limit
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else copy.deepcopy(v)
    return out


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its parts;
    ``overrides`` ({"pipeline": ..., "traffic": ...}) shrink it for tests."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    bench_dir = os.path.join(root, "benchmark")
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{w['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    overrides = overrides or {}
    config = dict(config, pipeline=merge(config["pipeline"],
                                         overrides.get("pipeline")))
    traffic = merge(traffic, overrides.get("traffic"))
    return Cell(name, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "lbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(cell: Cell, root: str = ROOT) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"], root)
            for m in cell.per_layer}
