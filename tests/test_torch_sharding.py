"""The port's sharded search (``gloc3d_tpu_torch/parallel/sharding.py``,
``index/ivf.py::ShardedIVF``, ``GlobalLocalizer.shard_bank``) over a gloo
group of two ranks on the CPU, against JAX's sharded calls on a 2-device
mesh of the conftest's virtual CPU devices.

One group (two fresh processes running ``tests/_torch_dist_worker.py``,
which import neither JAX nor this conftest) runs every case once for the
whole file, while this process computes JAX's side; each rank writes what
it got, and the tests compare both ranks' results with JAX's.

Tolerances are the unsharded parity tests': ids equal; fp32 distances
within atol 1e-4 and int8 ones within rtol / atol 1e-6
(``test_torch_topk_bank.py``), IVF distances within rtol 1e-5 / atol 1e-5 of
the cancelled terms (``test_torch_ivf.py``), the localizer's within
``test_torch_pipeline.py``'s (descriptors of two frameworks). The inputs are
drawn from numpy seeds, and the flat cases check that neighbouring
distances lie further apart than the tolerance, so that equal ids are a
fair demand. Exact ties across the two shards must go to the earliest
global index.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import gloc3d_tpu.parallel.sharding as jax_sharding
from gloc3d_tpu.index.ivf import IVFBank as JaxIVF
from gloc3d_tpu.index.ivf import ShardedIVF as JaxShardedIVF
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.parallel.sharding import ShardedBank as JaxShardedBank
from gloc3d_tpu.ops.topk import quantize_rows as jax_quantize
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.index.bank import DescriptorBank
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.parallel import merge_topk
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from test_pipeline import scan_at
from test_torch_ivf import _data, _unit_data
from test_torch_pipeline import CFG, DB_POSES, N_PTS, QUERIES, _scans
from test_torch_threads import _two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
WORLD = 2
EXTRA_POSE = (40.0, 40.0, 0.0)   # a keyframe added after sharding


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gapped(q, bank, k, tol, valid=None):
    """The flat cases' data: each query's k + 1 nearest distances (float64)
    lie further apart than ``tol``, so ids must agree."""
    d2 = ((q[:, None, :].astype(np.float64) - bank[None]) ** 2).sum(-1)
    if valid is not None:
        d2 = np.where(valid[None], d2, np.inf)
    near = np.sort(d2, 1)[:, :k + 1]
    near = near[np.isfinite(near).all(1)]
    assert np.diff(near, axis=1).min() > 10 * tol


def _inputs():
    rng = np.random.RandomState(0)
    inp = {"topk_q": rng.randn(4, 32).astype(np.float32),
           "topk_bank": rng.randn(640, 32).astype(np.float32),
           "topk_valid": rng.rand(640) < 0.5}
    _gapped(inp["topk_q"], inp["topk_bank"], 10, 1e-4)
    _gapped(inp["topk_q"], inp["topk_bank"], 10, 1e-4, inp["topk_valid"])
    # one row copied to globals 20 (rank 0, local 20), 35 and 50 (rank 1,
    # locals 3 and 18): the earliest global index wins, not the lowest
    # local one
    tie = rng.randn(64, 16).astype(np.float32)
    tie[[35, 50]] = tie[20]
    inp["tie_bank"], inp["tie_q"] = tie, tie[[20]] + 0.0
    d = rng.randn(640, 64).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inp["int8_bank"] = d
    inp["int8_q"] = d[:8] + 0.01 * rng.randn(8, 64).astype(np.float32)
    inp["sb_rows"] = np.random.RandomState(3).randn(48, 16).astype(
        np.float32)
    _gapped(inp["sb_rows"][7:9] + 0.01, inp["sb_rows"], 4, 1e-4)
    inp["ivf_none_data"] = _data(2000, 32)
    inp["ivf_int8_data"] = _unit_data(2000, 32)
    for quantize in ("none", "int8"):
        data = inp[f"ivf_{quantize}_data"]
        inp[f"ivf_{quantize}_q"] = data[[3, 123, 777, 1600, 1999]] + 0.01
    inp["kf_pts"], inp["kf_mask"] = _scans(DB_POSES)
    inp["q_pts"], inp["q_mask"] = _scans(QUERIES)
    inp["extra_pts"], inp["extra_mask"] = scan_at(*EXTRA_POSE, n=N_PTS)
    inp["cfg_json"] = np.array(CFG.to_json())
    return inp


def _jitted(fn, n):
    """JAX's sharded top-k ``fn`` (n array arguments before k) under one
    ``jax.jit`` per (mesh, k, axis, valid given): the package calls it
    eagerly, and an eager ``shard_map`` compiles on every call."""
    cache = {}

    def call(mesh, *args, valid=None, axis="data"):
        arrays, k, rest = args[:n], args[n], args[n + 1:]
        valid = rest[0] if rest else valid
        axis = rest[1] if len(rest) > 1 else axis
        key = (id(mesh), k, axis, valid is None)
        if key not in cache:
            cache[key] = jax.jit(lambda *a: fn(
                mesh, *a[:n], k, a[n] if len(a) > n else None, axis))
        return cache[key](*arrays, *(() if valid is None else (valid,)))

    return call


def _jax_ivf(inp, quantize):
    data = inp[f"ivf_{quantize}_data"]
    ref = JaxIVF(dim=32, num_cells=16, cell_capacity=64, nprobe=4,
                 quantize=quantize)
    ref.train(data[:500], key=jax.random.PRNGKey(0))
    ref.add(data[:1500])
    return ref


def _jax_side(inp, mesh, params, ivfs):
    """JAX's sharded results on the same inputs, the trained IVF indexes
    whose centroids the ranks take and the model parameters they take."""
    want = {}
    q, bank = jnp.asarray(inp["topk_q"]), jnp.asarray(inp["topk_bank"])
    topk = jax_sharding.sharded_topk
    want["topk_"] = topk(mesh, q, bank, 10)
    want["topk_valid"] = topk(mesh, q, bank, 10,
                              jnp.asarray(inp["topk_valid"]))
    want["topk_tie"] = topk(mesh, jnp.asarray(inp["tie_q"]),
                            jnp.asarray(inp["tie_bank"]), 4)
    codes, scales, bsq = jax_quantize(jnp.asarray(inp["int8_bank"]))
    want["topk_int8"] = jax_sharding.sharded_topk_int8(
        mesh, jnp.asarray(inp["int8_q"]), codes, scales, bsq, 10)

    rows = inp["sb_rows"]
    sb = JaxShardedBank(mesh, dim=16, capacity=64)
    for i in range(0, len(rows), 5):
        sb.add(rows[i:i + 5])
    qs = rows[7:9] + 0.01
    want["sb"] = sb.query(qs, k=4)
    want["sb_x"] = sb.query(qs, k=4, exclude_after=8)
    sb.truncate(10)
    want["sb_t"] = sb.query(qs, k=4)
    sb8 = JaxShardedBank(mesh, dim=64, capacity=640, quantize="int8")
    sb8.add(inp["int8_bank"])
    want["sb8"] = sb8.query(inp["int8_q"], k=10)
    want["sb8_host"] = sb8.to_host()

    for quantize in ("none", "int8"):
        s = JaxShardedIVF(mesh, ivfs[quantize])
        q = inp[f"ivf_{quantize}_q"]
        key = f"ivf_{quantize}"
        want[key] = s.query(q, k=5)
        want[f"{key}_x"] = s.query(q, k=5, exclude_after=700)
        s.add(inp[f"ivf_{quantize}_data"][1500:])
        want[f"{key}_add"] = s.query(q, k=5)

    model = jax_build_model(CFG.model, CFG.voxel)
    loc = JaxLocalizer(CFG, model, params, host_stats=True)
    for sl in (slice(0, 4), slice(4, None)):
        loc.add_keyframes(inp["kf_pts"][sl], inp["kf_mask"][sl])
    flat_rows = np.asarray(loc.bank.data)
    loc.shard_bank(mesh)
    want["loc"] = [loc.locate(p, m)
                   for p, m in zip(inp["q_pts"], inp["q_mask"])]
    want["loc_xr"] = loc.bank.query(flat_rows[:1], k=3, exclude_recent=True)
    loc.add_keyframes(inp["extra_pts"][None], inp["extra_mask"][None])
    want["loc_extra"] = loc.locate(inp["extra_pts"], inp["extra_mask"])
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices):
    """Start the two ranks, compute JAX's side meanwhile, and return
    (both ranks' results, JAX's, the run's directory, the parameters)."""
    out = tmp_path_factory.mktemp("sharding")
    inp = _inputs()
    mesh = Mesh(np.array(devices[:WORLD]), ("data",))
    model = jax_build_model(CFG.model, CFG.voxel)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(inp["kf_pts"][:1]),
                                 jnp.asarray(inp["kf_mask"][:1]))
    state = flax_to_state_dict(params)
    torch.save(state, out / "params.pt")
    # the ranks take JAX's IVF centroids: trained first, written with the
    # rest of the inputs
    ivfs = {q: _jax_ivf(inp, q) for q in ("none", "int8")}
    for quantize, ref in ivfs.items():
        inp[f"ivf_{quantize}_centroids"] = np.asarray(ref.centroids)
    np.savez(out / "inputs.npz", **inp)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name, n in (("sharded_topk", 2), ("sharded_topk_int8", 4)):
                mp.setattr(jax_sharding, name,
                           _jitted(getattr(jax_sharding, name), n))
            want = _jax_side(inp, mesh, params, ivfs)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return got, want, out, state


def _ranks(run, key):
    """``key`` from both ranks, which must agree bit for bit."""
    got = run[0]
    np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    return got[0][key]


@pytest.mark.parametrize("case", ["", "valid", "tie", "int8"])
def test_sharded_topk_matches_jax(run, case):
    d2, idx = (_ranks(run, f"topk_{case}_d2"), _ranks(run, f"topk_{case}_id"))
    want_d2, want_id = (np.asarray(x) for x in run[1][f"topk_{case}"])
    np.testing.assert_array_equal(idx, want_id)
    if case == "int8":
        np.testing.assert_allclose(d2, want_d2, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(d2, want_d2, atol=1e-4)
    if case == "tie":  # rank 0's copy, then rank 1's in index order
        np.testing.assert_array_equal(idx[0, :3], [20, 35, 50])


@pytest.mark.parametrize("case", ["sb", "sb_x", "sb_t", "sb8"])
def test_sharded_bank_matches_jax(run, case):
    d2, idx = _ranks(run, f"{case}_d2"), _ranks(run, f"{case}_id")
    want_d2, want_id = run[1][case]
    np.testing.assert_array_equal(idx, want_id)
    if case == "sb8":
        np.testing.assert_allclose(d2, want_d2, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(d2, want_d2, atol=1e-4)
    if case == "sb_x":
        assert (idx < 8).all()
    if case == "sb_t":
        assert (idx < 10).all()


def test_sharded_bank_keeps_its_rows_and_gathers_them(run):
    """Each rank stores its 32 of the 64 rows; to_host gathers the 48 live
    ones on every rank, the int8 bank dequantized as JAX does."""
    got = run[0]
    assert all(int(g["sb_len"]) == 48 and int(g["sb_local_rows"]) == 32
               for g in got)
    np.testing.assert_array_equal(_ranks(run, "sb_host"),
                                  np.load(run[2] / "inputs.npz")["sb_rows"])
    np.testing.assert_allclose(_ranks(run, "sb8_host"), run[1]["sb8_host"],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("case", ["", "_x", "_add"])
def test_sharded_ivf_matches_jax(run, quantize, case):
    key = f"ivf_{quantize}{case}"
    d2, idx = _ranks(run, f"{key}_d2"), _ranks(run, f"{key}_id")
    want_d2, want_id = run[1][key]
    data = np.load(run[2] / "inputs.npz")[f"ivf_{quantize}_data"]
    scale = 2.0 * float((data * data).sum(1).max())
    np.testing.assert_array_equal(idx, want_id)
    np.testing.assert_allclose(d2, want_d2, rtol=1e-5, atol=1e-5 * scale)
    if case == "_x":
        assert (idx < 700).all()
    assert all(int(g[f"ivf_{quantize}_local_cells"]) == 8 for g in run[0])


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_shard_bank_locate_matches_jax(run, i):
    got = {k: _ranks(run, f"loc_{i}_{k}")
           for k in ("ok", "db", "cand", "dist", "t")}
    want = run[1]["loc"][i]
    assert bool(got["ok"]) == want.success
    assert int(got["db"]) == want.db_index
    np.testing.assert_array_equal(got["cand"], want.candidates)
    np.testing.assert_allclose(got["dist"], want.candidate_dists,
                               atol=1e-3, rtol=2e-3)
    if want.success:
        np.testing.assert_allclose(got["t"], np.asarray(
            want.pose.translation), atol=1e-3)


def test_shard_bank_exclude_recent_and_add_match_jax(run):
    d2, idx = _ranks(run, "loc_xr_d2"), _ranks(run, "loc_xr_id")
    want_d2, want_id = run[1]["loc_xr"]
    np.testing.assert_array_equal(np.isinf(d2), np.isinf(want_d2))
    finite = np.isfinite(want_d2)
    np.testing.assert_array_equal(idx[finite], np.asarray(want_id)[finite])
    assert all(int(g["loc_len_after_add"]) == len(DB_POSES) + 1
               for g in run[0])
    want = run[1]["loc_extra"]
    assert int(_ranks(run, "loc_extra_db")) == want.db_index == len(DB_POSES)
    np.testing.assert_array_equal(_ranks(run, "loc_extra_cand"),
                                  want.candidates)
    assert "sharded" in str(_ranks(run, "loc_fused_refused"))


def test_shard_bank_save_reloads_unsharded(run):
    """Rank 0 wrote the flat bank.npz (and the map); an unsharded bank and
    localizer load it back and locate as the sharded one did."""
    got, _, out, state = run
    back = DescriptorBank.load(str(out / "map" / "bank.npz"), device="cpu")
    np.testing.assert_array_equal(back.data.numpy(), got[0]["loc_flat_rows"])
    loc = GlobalLocalizer(CFG, build_model(CFG.model, CFG.voxel), state,
                          host_stats=True, device="cpu")
    loc.load(str(out / "map"))
    inp = np.load(out / "inputs.npz")
    res = loc.locate(inp["q_pts"][0], inp["q_mask"][0])
    assert res.db_index == int(got[0]["loc_0_db"])
    np.testing.assert_array_equal(res.candidates, got[0]["loc_0_cand"])


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_shard_bank_ivf_matches_the_flat_search(run, i):
    """The IVF backend trained by the port on each rank, sharded, searched
    at full probe (the exact search) through ``locate_batch``: the same
    centroids on both ranks, and the sharded flat bank's results, which are
    JAX's."""
    _ranks(run, "ivf_centroids")
    for k in ("ok", "db", "cand", "t"):
        np.testing.assert_array_equal(_ranks(run, f"ivf_{i}_{k}"),
                                      _ranks(run, f"loc_{i}_{k}"))
    np.testing.assert_allclose(_ranks(run, f"ivf_{i}_dist"),
                               _ranks(run, f"loc_{i}_dist"), atol=1e-4)
    np.testing.assert_array_equal(_ranks(run, f"ivf_{i}_cand"),
                                  run[1]["loc"][i].candidates)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_merge_topk_keeps_the_earliest_global_index(k):
    """Plain tensors, no group: rank 0 holds ids 0-4, rank 1 ids 5-9; equal
    distances go to the earlier rank, then the earlier id."""
    d2 = torch.tensor([[[0.1, 0.2, 0.2, 0.5, 0.9]],
                       [[0.1, 0.1, 0.2, 0.3, 0.9]]])
    ids = torch.tensor([[[3, 0, 4, 1, 2]], [[6, 9, 5, 8, 7]]])
    got_d2, got_id = merge_topk(d2, ids, k)
    want_id = [3, 6, 9, 0, 4][:k]
    np.testing.assert_array_equal(got_id[0].numpy(), want_id)
    np.testing.assert_allclose(got_d2[0].numpy(),
                               [0.1, 0.1, 0.1, 0.2, 0.2][:k])


def test_merge_topk_clamps_and_orders_inf_last():
    d2 = torch.tensor([[[-1e-7, torch.inf]], [[0.5, torch.inf]]])
    ids = torch.tensor([[[2, 0]], [[4, 5]]])
    got_d2, got_id = merge_topk(d2, ids, 3)
    np.testing.assert_array_equal(got_id[0].numpy(), [2, 4, 0])
    np.testing.assert_array_equal(got_d2[0].numpy(), [0.0, 0.5, np.inf])
