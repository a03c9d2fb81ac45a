"""What a run imports: nothing of JAX or the JAX package (top-level names
compared whole, so the port's ``gloc3d_tpu_torch`` passes and
``gloc3d_tpu`` does not), and a reference that imports nothing of the
port."""

import ast
import os
import subprocess
import sys

from lbench import cell, spec

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "gloc3d_tpu"}
BENCH = os.path.join(spec.ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for base, _, files in os.walk(os.path.join(BENCH, sub)):
        if "_cache" in base:
            continue
        yield from (os.path.join(base, f) for f in files if f.endswith(".py"))


def test_sources_import_no_jax():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)


def test_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "math", "typing", "contextlib", "numpy",
               "torch", "lbench"}
    for path in _sources(os.path.join("lbench", "reference")):
        mods = set(_imports(path))
        assert {m.split(".")[0] for m in mods} <= allowed, (path, mods)
        assert all(m.startswith("lbench.reference") for m in mods
                   if m.split(".")[0] == "lbench"), (path, mods)


def test_banned_modules_compares_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in BANNED:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "gloc3d_tpu_torch.probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert cell.banned_modules() == []
    monkeypatch.setitem(sys.modules, "gloc3d_tpu.probe", sys)
    assert cell.banned_modules() == ["gloc3d_tpu"]


RUN_TINY = """
import sys
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
{block}
from conftest import TINY
from lbench import cell
line = cell.run("i2i-aligned-relocalize", 3, 0.3, True, "cpu",
                overrides=TINY, log=lambda m: None)
assert line["correct"], line["check"]
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""

BLOCK_PORT = """
import importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "gloc3d_tpu_torch":
            raise ImportError("the reference may not import the port")
sys.meta_path.insert(0, Block())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", RUN_TINY.format(
            root=spec.ROOT, bench=BENCH,
            tests=os.path.join(BENCH, "tests"), block="")],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert "gloc3d_tpu_torch" in tops
    assert not tops & BANNED


def test_reference_runs_with_the_port_blocked():
    code = f"""
import sys
sys.path[:0] = [{spec.ROOT!r}, {BENCH!r}]
{BLOCK_PORT}
import numpy as np, torch
from lbench import weights, world
from lbench.reference.pipeline import Reference
cfg = __import__("json").load(open({os.path.join(BENCH, "configs", "s2s-pointpillar-netvladfc.json")!r}))["pipeline"]
cfg["voxel"].update(max_points=4096, xbound=[-10.0, 10.0, 0.5], ybound=[-6.0, 6.0, 0.5])
cfg["ground"].update(num_candidates=256, ransac_iters=32)
cfg["bev"]["image_size"] = 128
p = weights.seeded_params(cfg["model"], 1, "cpu")
w = world.make_world(1, 40, 30.0)
scans = [world.tilted_scan(w, (0.0, 0.0, 0.5), (0.01, 0.0, 1.7), 4096, i, 25.0, 1000) for i in range(2)]
pts = np.stack([s[0] for s in scans]); msk = np.stack([s[1] for s in scans])
weights.init_clusters(p, cfg, pts, msk, 1, "cpu")
ref = Reference(cfg, p, "cpu")
m = ref.build_map(pts, msk, [5], 2, torch.zeros((3, 128)))
out = ref.locate(pts[:1], msk[:1], 6, m)
assert out["ids"].shape == (1, 5)
assert "gloc3d_tpu_torch" not in sys.modules
print("ok")
"""
    code = code.replace('cfg["bev"]["image_size"] = 128',
                        'cfg["bev"]["image_size"] = 128\n'
                        'cfg["index"]["top_k"] = 5')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stderr[-3000:]
