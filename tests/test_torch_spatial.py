"""The port's i2i spatial partition (``parallel/spatial.py``,
``GlobalLocalizer.shard_spatial``) over a gloo group of two ranks on the
CPU, against the port's unsharded forward and JAX's spatial forward on a
2-device mesh of the conftest's virtual CPU devices.

One group (two fresh processes running ``tests/_torch_spatial_worker.py``,
which import neither JAX nor this conftest) runs every case once for the
whole file, while this process computes JAX's side.

The cases are tests/test_spatial.py's: VGG16 + NetVLAD-FC at 128² with 8
clusters in fp32, two random images through ``spatial_sharded_apply``, and
eight wall images as keyframes with two of them as queries through
``shard_spatial`` + ``locate_batch``. Both packages get JAX's seeded
weights with NetVLAD's centroids from the keyframes' own normalised VGG
features (as tests/test_torch_i2i.py: the seeded centroids make every
descriptor nearly the same). Held: the spatial forward within JAX's own
rtol 2e-5 / atol 2e-6 of the unsharded forward (the halo exchange is
exact; the heads' sums change order), and within test_torch_i2i.py's
descriptor bounds (atol 2e-4 / rtol 2e-3) of JAX's spatial forward; the
localizer's results those of the unsharded localizer; ResNet18,
MobileNetV2 and AlexNet at 96² (AlexNet's 11×11/4 stem and 3×3/2 pools
leave uneven bands: 23 → 11 → 5 rows) and ResNet18 at 32² (an empty band)
within rtol 2e-5 / atol 2e-6 of their unsharded forwards."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gloc3d_tpu.config import (
    BEVConfig, IndexConfig, MatchConfig, ModelConfig, PipelineConfig,
    VoxelConfig,
)
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.parallel.spatial import (
    spatial_sharded_apply as jax_spatial_apply,
)
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch.config import PipelineConfig as PortConfig
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.parallel import check_divisible
from gloc3d_tpu_torch.parallel.launch import free_port
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from test_torch_threads import _two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_spatial_worker.py")
WORLD = 2
S = 128
CFG = PipelineConfig(
    bev=BEVConfig(image_size=S, max_points=512),
    voxel=VoxelConfig(max_points=512),
    model=ModelConfig(encoder="vgg16", encoder_dim=512, num_clusters=8,
                      compute_dtype="float32"),
    index=IndexConfig(dim=512, top_k=3, capacity=16),
    match=MatchConfig(image_size=S, min_score=0.05, min_overlap_pixels=4),
)
ZOO = ("resnet18_96", "mobilenet_96", "alexnet_96", "resnet18_32")


def _wall_img(seed):
    """tests/test_spatial.py's structured BEV image: random wall
    segments."""
    r = np.random.RandomState(seed)
    img = np.ones((S, S), np.float32)
    for _ in range(12):
        x0, y0 = r.randint(10, S - 10, 2)
        dx, dy = r.randint(-1, 2), r.randint(-1, 2)
        if dx == 0 and dy == 0:
            dx = 1
        for t in range(r.randint(10, 40)):
            x, y = x0 + dx * t, y0 + dy * t
            if 0 <= x < S and 0 <= y < S:
                img[y, x] = 0.0
    return img


def _variables(model, db3):
    """JAX's seeded variables, NetVLAD's centroids from the keyframes'
    normalised VGG features (alpha 30), as numpy."""
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(db3[:1]))
    feat = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, method=model.encode))(v, jnp.asarray(db3))).reshape(-1, 512)
    feat = feat / (np.linalg.norm(feat, axis=1, keepdims=True) + 1e-12)
    cents = feat[np.random.RandomState(0).permutation(len(feat))[:8]]
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"]["pool"]["centroids"] = cents.astype(np.float32)
    v["params"]["pool"]["conv_weight"] = (30.0 * cents.T).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices):
    """Start the two ranks, compute JAX's side meanwhile, and return (both
    ranks' results, JAX's)."""
    out = tmp_path_factory.mktemp("spatial")
    env = {k: w for k, w in os.environ.items() if k != "XLA_FLAGS"}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        # the ranks import torch and join their group meanwhile
        model = jax_build_model(CFG.model, CFG.voxel)
        db = np.stack([_wall_img(s) for s in range(8)])
        db3 = np.repeat(db[..., None], 3, axis=-1)
        v = _variables(model, db3)
        inp = {"imgs": (np.random.RandomState(1).rand(2, S, S, 3)
                        > 0.02).astype(np.float32), "db3": db3,
               "q3": db3[:2].copy(), "cfg_json": np.array(CFG.to_json())}
        torch.save(flax_to_state_dict(v, "vgg16"), out / "params.pt")
        np.savez(out / "inputs.tmp.npz", **inp)
        os.replace(out / "inputs.tmp.npz", out / "inputs.npz")
        mesh = Mesh(np.array(devices[:WORLD]), ("data",))
        want = {"sp": np.asarray(jax_spatial_apply(mesh, model)(
            v, jnp.asarray(inp["imgs"])))}
        loc = JaxLocalizer(CFG, model, v)
        loc.shard_spatial(mesh)
        loc.add_keyframes(db3)
        want["batch"] = loc.locate_batch(inp["q3"])
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return got, want


def _ranks(run, key):
    """``key`` from both ranks, which must agree bit for bit."""
    got = run[0]
    np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    return got[0][key]


def test_spatial_forward_matches_unsharded_and_jax(run):
    sp = _ranks(run, "vgg_sp")
    np.testing.assert_allclose(sp, _ranks(run, "vgg_ref"), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(sp, run[1]["sp"], atol=2e-4, rtol=2e-3)


def test_spatial_forward_refuses_non_square_images(run):
    """Every rank raises ValueError for (B, S, S − 16, 3) images."""
    for got in run[0]:
        assert "square" in str(got["non_square"]), got["non_square"]


@pytest.mark.parametrize("mode,n", [("batch", 2), ("one", 1), ("fused", 1)])
def test_shard_spatial_locates_as_unsharded(run, mode, n):
    """shard_spatial (with shard_extraction too: images keep the spatial
    forward): the keyframe descriptors within the forward's bounds, and
    locate_batch / locate / locate_fused the unsharded localizer's results
    (same success, keyframe and ranked candidates, pose within 1e-4 m)."""
    np.testing.assert_allclose(_ranks(run, "sp_bank"),
                               _ranks(run, "base_bank"), rtol=2e-5,
                               atol=2e-6)
    for i in range(n):
        got = {f: _ranks(run, f"sp_{mode}_{i}_{f}")
               for f in ("ok", "db", "cand", "dist", "t")}
        base = {f: _ranks(run, f"base_{mode}_{i}_{f}")
                for f in ("ok", "db", "cand", "dist", "t")}
        assert bool(got["ok"]) and bool(base["ok"])
        assert int(got["db"]) == int(base["db"])
        np.testing.assert_array_equal(got["cand"], base["cand"])
        np.testing.assert_allclose(got["dist"], base["dist"], atol=1e-5)
        np.testing.assert_allclose(got["t"], base["t"], atol=1e-4)


@pytest.mark.parametrize("i", range(2))
def test_shard_spatial_locate_batch_matches_jax(run, i):
    """Against JAX's shard_spatial + locate_batch: success, keyframe and
    ranked candidates equal, distances and translation within
    test_torch_i2i.py's bounds."""
    want = run[1]["batch"][i]
    assert bool(_ranks(run, f"sp_batch_{i}_ok")) == want.success
    assert int(_ranks(run, f"sp_batch_{i}_db")) == want.db_index
    np.testing.assert_array_equal(_ranks(run, f"sp_batch_{i}_cand"),
                                  want.candidates)
    np.testing.assert_allclose(_ranks(run, f"sp_batch_{i}_dist"),
                               want.candidate_dists, atol=1e-3, rtol=2e-3)
    if want.success:
        np.testing.assert_allclose(_ranks(run, f"sp_batch_{i}_t"),
                                   np.asarray(want.pose.translation),
                                   atol=1e-3)


@pytest.mark.parametrize("case", ZOO)
def test_zoo_spatial_forward_matches_unsharded(run, case):
    np.testing.assert_allclose(_ranks(run, f"{case}_sp"),
                               _ranks(run, f"{case}_ref"), rtol=2e-5,
                               atol=2e-6)


def test_check_divisible():
    """tests/test_spatial.py's cases."""
    check_divisible(768, 8)
    with pytest.raises(ValueError):
        check_divisible(192, 8, n_pools=4)
    with pytest.raises(ValueError):
        check_divisible(100, 8)


def test_shard_spatial_rejects_pointpillar():
    cfg = PortConfig.s2s()
    loc = GlobalLocalizer(cfg, build_model(cfg.model, cfg.voxel),
                          device="cpu")
    with pytest.raises(ValueError, match="image"):
        loc.shard_spatial(None)


def test_ranks_load_no_jax(run):
    """The ranks ran the port alone: no module of JAX, flax or the JAX
    package was loaded in them."""
    for got in run[0]:
        assert got["jax_modules"].size == 0, got["jax_modules"]
