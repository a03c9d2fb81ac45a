"""The port's profiling module (``gloc3d_tpu_torch/profiling.py``) on the
CPU: the registry of spans and counters and the profiler trace.

The registry records only while a ``torch.profiler`` profile records, or
within ``profiling.record()``. A tiny aligned localizer (PointPillar at a
2 048-point pad, 128² BEV images, a 512-candidate ground RANSAC, a
two-keyframe device store) runs ``locate_fused`` and ``locate_batch`` with
and without a profile: an on-map query registers at its top candidate, an
off-map one runs stage 2.
On the CPU ``locate_fused`` runs its programs eagerly, and the device spans
take host time. The file imports no JAX, so that its card case runs on a
machine without it (``--noconftest -m cuda``).
"""

import json
import os

import numpy as np
import pytest
import torch

from gloc3d_tpu_torch import profiling
from gloc3d_tpu_torch.config import (
    BEVConfig, GroundConfig, IndexConfig, MatchConfig, ModelConfig,
    PipelineConfig, VoxelConfig,
)
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from gloc3d_tpu_torch.profiling import TRACE_FILE, trace
from test_torch_threads import _two_threads  # noqa: F401

N_PTS = 2048
CFG = PipelineConfig(
    bev=BEVConfig(image_size=128, max_points=N_PTS),
    voxel=VoxelConfig(max_points=N_PTS),
    model=ModelConfig(encoder="pointpillar", encoder_dim=128,
                      compute_dtype="float32"),
    index=IndexConfig(dim=128, top_k=3, capacity=8),
    match=MatchConfig(image_size=128, min_score=0.1, min_overlap_pixels=16),
    ground=GroundConfig(num_candidates=512, ransac_iters=64),
)
ON_MAP, OFF_MAP = (25.0, 5.0, 1.2), (-12.0, 8.0, -2.0)
HOST = {"locate_fused": ["draws", "stage", "replay", "wait", "compose"],
        "locate_batch": ["stage", "draws", "wait", "compose"]}
DEVICE = ["ground", "bev", "encoder", "search", "store_gather", "register"]
FULL = ["store_gather_full", "register_full"]


def _walls(n_walls=60, extent=80.0):
    """test_pipeline.py's world: 60 walls, 3 m high, over ±80 m."""
    rng = np.random.RandomState(0)
    pts = []
    for _ in range(n_walls):
        x0, y0 = rng.uniform(-extent, extent, 2)
        ang = rng.uniform(0, np.pi)
        ts = rng.uniform(0, rng.uniform(4, 12), 220)
        pts.append(np.stack([x0 + np.cos(ang) * ts, y0 + np.sin(ang) * ts,
                             rng.uniform(0.0, 3.0, 220)], 1))
    return np.concatenate(pts).astype(np.float32)


WORLD = _walls()


def _scan(x, y, yaw, seed=1):
    """The walls seen from (x, y, yaw) at 1.7 m over a ground plane of
    1 200 returns, padded to N_PTS."""
    rng = np.random.RandomState(seed)
    near = np.linalg.norm(WORLD[:, :2] - np.array([x, y]), axis=1) < 35.0
    ground = np.c_[rng.uniform(-18, 18, (1200, 2)) + [x, y], np.zeros(1200)]
    pts = np.concatenate([WORLD[near], ground])
    c, s = np.cos(-yaw), np.sin(-yaw)
    px, py = pts[:, 0] - x, pts[:, 1] - y
    out = np.stack([c * px - s * py, s * px + c * py, pts[:, 2] - 1.7,
                    np.zeros(len(pts))], 1).astype(np.float32)
    out = out[rng.permutation(len(out))[:N_PTS]]
    padded = np.zeros((N_PTS, 4), np.float32)
    padded[:len(out)] = out
    mask = np.zeros(N_PTS, np.float32)
    mask[:len(out)] = 1.0
    return padded, mask


@pytest.fixture(scope="module")
def loc():
    model = init_params(build_model(CFG.model, CFG.voxel), seed=0)
    out = GlobalLocalizer(CFG, model, device="cpu", align_ground=True,
                          device_keyframes=True, host_mirror=False)
    pts, mask = _scan(*ON_MAP, seed=0)
    out.add_keyframes(np.stack([pts] * 2), np.stack([mask] * 2))
    return out


def _call(loc, entry, where):
    """One call of ``entry`` on the queries at ``where`` (its results)."""
    scans = [_scan(*p) for p in where]
    loc._gen.manual_seed(7)
    if entry == "locate_fused":
        return [loc.locate_fused(*scans[0])]
    return loc.locate_batch(np.stack([s[0] for s in scans]),
                            np.stack([s[1] for s in scans]))


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("entry, where", [
    ("locate_fused", [ON_MAP]), ("locate_batch", [ON_MAP, OFF_MAP])])
def test_nothing_recorded_without_a_profiler(loc, clean, entry, where):
    _call(loc, entry, where)
    s = profiling.summary()
    assert s["spans"] == {} and s["paths"] == {}
    assert s["counters"] == {"captures": 0}


def _expected(entry, stage2):
    """Path → count of one traced call on the CPU. ``locate_fused``: its
    device spans run inside the eager program (``replay``), a second fetch
    and replay when stage 2 runs. ``locate_batch`` of the on-map and the
    off-map query: 15 synchronising reads (the bank's two, stage 1's
    successes, both stages' six lanes spliced on the host) and, in the
    composition, the registered query's ground transform (two)."""
    want = {entry: 1, f"{entry}/compose": 1, f"{entry}/draws": 1,
            f"{entry}/stage": 1}
    if entry == "locate_fused":
        runs = 2 if stage2 else 1
        want.update({f"{entry}/replay": runs, f"{entry}/wait": runs})
        under = f"{entry}/replay/"
    else:
        want.update({f"{entry}/wait": 15, f"{entry}/compose/wait": 2})
        under = f"{entry}/"
    for name in DEVICE + (FULL if stage2 else []):
        want[under + name] = 1
    return want


@pytest.mark.parametrize("entry, where, stage2", [
    ("locate_fused", [ON_MAP], False), ("locate_fused", [OFF_MAP], True),
    ("locate_batch", [ON_MAP, OFF_MAP], True)])
def test_a_traced_call_records_every_span_under_its_parent(
        loc, clean, tmp_path, entry, where, stage2):
    with trace(str(tmp_path)):
        results = _call(loc, entry, where)
    assert [r.success for r in results] == [p == ON_MAP for p in where]
    s = profiling.summary()
    assert {p: v["count"] for p, v in s["paths"].items()} == _expected(
        entry, stage2)
    kinds = {n: v["kind"] for n, v in s["spans"].items()}
    assert kinds == dict([(entry, "host")] + [(n, "host") for n in
                                               HOST[entry]]
                         + [(n, "device") for n in
                            DEVICE + (FULL if stage2 else [])])
    assert all(v["ms"] >= 0 for v in s["paths"].values())
    want = {f"{entry}.calls": 1, f"{entry}.queries": len(where),
            "captures": 0}
    if stage2:
        want["stage2_runs"] = 1
    assert s["counters"] == want


@pytest.mark.parametrize("entry, where", [
    ("locate_fused", [OFF_MAP]), ("locate_batch", [ON_MAP, OFF_MAP])])
def test_the_trace_holds_the_host_spans_as_annotations(
        loc, clean, tmp_path, entry, where):
    with trace(str(tmp_path)):
        _call(loc, entry, where)
    events = json.load(open(tmp_path / TRACE_FILE))["traceEvents"]
    notes = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {entry, *HOST[entry]} <= notes
    assert not notes & set(DEVICE + FULL)  # timed by events, not on the host


@pytest.mark.parametrize("entry, where", [
    ("locate_fused", [ON_MAP]), ("locate_fused", [OFF_MAP]),
    ("locate_batch", [ON_MAP, OFF_MAP])])
def test_answers_are_bit_equal_with_and_without_the_profiler(
        loc, clean, tmp_path, entry, where):
    plain = _call(loc, entry, where)
    with trace(str(tmp_path)):
        traced = _call(loc, entry, where)
    for a, b in zip(plain, traced):
        assert (a.success, a.db_index) == (b.success, b.db_index)
        np.testing.assert_array_equal(a.candidates, b.candidates)
        np.testing.assert_array_equal(a.candidate_dists, b.candidate_dists)
        assert a.match_score == b.match_score
        if a.success:
            np.testing.assert_array_equal(a.match_xy_yaw, b.match_xy_yaw)
            np.testing.assert_array_equal(a.pose.rotation, b.pose.rotation)
            np.testing.assert_array_equal(a.pose.translation,
                                          b.pose.translation)


def test_reset_clears_the_registry(loc, clean, tmp_path):
    with trace(str(tmp_path)):
        _call(loc, "locate_fused", [OFF_MAP])
    assert profiling.summary()["spans"]
    profiling.reset()
    s = profiling.summary()
    assert s["spans"] == {} and s["paths"] == {}
    assert s["counters"] == {"captures": 0}


def test_spans_never_synchronise(loc, clean, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _call(loc, "locate_fused", [OFF_MAP])
        _call(loc, "locate_batch", [ON_MAP, OFF_MAP])
        with profiling.entry("outer", 3), profiling.span("inner"), \
                profiling.device_span("work", torch.device("cpu")):
            profiling.to_host(torch.ones(4))
    s = profiling.summary()
    assert s["paths"]["outer/inner/work"]["kind"] == "device"
    assert s["paths"]["outer/inner/wait"]["count"] == 1


def test_entry_numbers_calls_and_counters_record_only_under_a_profile(
        clean):
    from torch.profiler import ProfilerActivity, profile

    profiling.count("stage2_runs", 5)  # nothing records yet
    profiling.count_capture()  # always counted
    assert profiling.entry("e", 2) is profiling.span("s")  # null contexts
    with profile(activities=[ProfilerActivity.CPU]):
        numbers = []
        for _ in range(3):
            with profiling.entry("e", 2) as call:
                profiling.count("stage2_runs")
            numbers.append(call.args)
        with profiling.entry("f", 1) as call:
            numbers.append(call.args)
    assert numbers == ["call 1", "call 2", "call 3", "call 1"]
    s = profiling.summary()
    assert s["counters"] == {"captures": 1, "e.calls": 3, "e.queries": 6,
                             "f.calls": 1, "f.queries": 1, "stage2_runs": 3}
    assert s["paths"]["e"]["count"] == 3 and s["spans"]["e"]["kind"] == "host"


@pytest.mark.parametrize("entry, where, stage2", [
    ("locate_fused", [ON_MAP], False), ("locate_fused", [OFF_MAP], True),
    ("locate_batch", [ON_MAP, OFF_MAP], True)])
def test_record_records_every_span_without_a_profiler(
        loc, clean, entry, where, stage2):
    """Within ``record()`` the registry records as under a profile, and
    the answers are those of a call that records nothing."""
    plain = _call(loc, entry, where)
    with profiling.record():
        recorded = _call(loc, entry, where)
    s = profiling.summary()
    assert {p: v["count"] for p, v in s["paths"].items()} == _expected(
        entry, stage2)
    assert s["counters"][f"{entry}.queries"] == len(where)
    assert s["counters"].get("stage2_runs", 0) == int(stage2)
    for a, b in zip(plain, recorded):
        assert (a.success, a.db_index, a.match_score) == (
            b.success, b.db_index, b.match_score)
        np.testing.assert_array_equal(a.candidates, b.candidates)


def test_record_nests_and_records_nothing_after_it(loc, clean):
    with profiling.record():
        with profiling.record():
            _call(loc, "locate_fused", [ON_MAP])
        _call(loc, "locate_fused", [ON_MAP])  # the outer block records on
    _call(loc, "locate_fused", [ON_MAP])
    s = profiling.summary()
    assert s["counters"]["locate_fused.calls"] == 2
    assert s["paths"]["locate_fused"]["count"] == 2
    assert profiling.span("s") is profiling.device_span(
        "d", torch.device("cpu"))  # null contexts again


def test_summary_reads_the_kernels_launch_counters(clean):
    from gloc3d_tpu_torch.kernels import bin_sums, segment_sum

    k = profiling.summary()["kernels"]
    assert k["k2"] == {f: getattr(bin_sums.pillar_bin_sums, f)
                       for f in ("launches", "captured", "replayed")}
    assert k["k1"]["launches"] == segment_sum.segment_sum_sorted.launches


@pytest.mark.cuda
def test_captured_device_spans_time_each_replay(clean):
    """A device span captured into a CUDA graph records external timing
    events at every replay; ``read_marks`` adds their times only while the
    registry records, and within ``record()`` they time the kernels
    between them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        (x @ x).sum()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with profiling.graph_marks() as marks, torch.cuda.graph(graph):
        with profiling.device_span("mm", dev):
            y = x @ x
        with profiling.device_span("sum", dev):
            y.sum()
    assert [m[0] for m in marks] == ["mm", "sum"]
    graph.replay()
    y.cpu()
    profiling.read_marks(marks)
    assert profiling.summary()["paths"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.entry("e", 1):
            graph.replay()
            y.cpu()
            profiling.read_marks(marks)
    paths = profiling.summary()["paths"]
    assert paths["e/replay/mm"]["ms"] > 0
    assert paths["e/replay/mm"]["kind"] == "device"
    # within record() the captured span times the matmul the replay runs:
    # within 10 % of the same matmul timed eagerly by CUDA events, queued
    # behind a sleep so that the host's launch is not timed
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    eager = []
    for _ in range(20):
        torch.cuda._sleep(1_000_000)
        start.record()
        x @ x
        end.record()
        end.synchronize()
        eager.append(start.elapsed_time(end))
    profiling.reset()
    with profiling.record():
        for _ in range(20):
            with profiling.entry("e", 1):
                graph.replay()
                y.cpu()
                profiling.read_marks(marks)
    captured = profiling.summary()["paths"]["e/replay/mm"]
    assert captured["count"] == 20
    eager_ms = sorted(eager[5:])[7]
    assert abs(captured["ms"] / 20 - eager_ms) <= 0.1 * eager_ms, (
        captured["ms"] / 20, eager)


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
