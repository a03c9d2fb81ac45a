"""The i2i slice (VGG16 + NetVLAD-FC on BEV images) in the port against the
JAX package, on the CPU at 64²-128² images in fp32.

Tolerances: the VGG feature map atol 1e-4 / rtol 1e-3 (13 fp32 convs summed
in another order; with ``vgg_pack_width`` True the JAX package runs its
first block on the width-packed layout, exact in fp32 up to summation
order); descriptors atol 2e-4 / rtol 2e-3, the s2s descriptor bound of
tests/test_torch_pointpillar.py; BEV images, top-k ids, success and
db_index equal; registration (dx, dy, yaw) 1e-4 and pose 1e-3 against JAX,
1e-5 within the port.

Both packages get the same weights: JAX's seeded init, with NetVLAD's
centroids taken from the encoder's own normalised features of the map
(the seeded centroids, uniform in [0, 1), dwarf unit-norm features and make
every descriptor nearly the same, so retrieval would rank by rounding
noise)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import (
    BEVConfig, GroundConfig, IndexConfig, MatchConfig, ModelConfig,
    PipelineConfig, VoxelConfig,
)
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.models.vgg import load_vggvlad_npz
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu_torch.convert import (
    flax_to_state_dict, load_reference_checkpoint,
)
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.models.vgg import VGG16_CFG, VGG16_CONV_IDX, conv_flops
from gloc3d_tpu_torch.ops.bev import batch_scan_to_bev
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from gloc3d_tpu_torch.train.cluster import init_vlad_from_data
from test_pipeline import scan_at
from test_pipeline_ground import tilted_scan
from test_torch_ground import _replayed_draws
from test_torch_threads import _two_threads  # noqa: F401


N_PTS = 4096
S = 128
CFG = PipelineConfig(
    bev=BEVConfig(image_size=S, max_points=N_PTS),
    voxel=VoxelConfig(max_points=N_PTS),
    model=ModelConfig(encoder="vgg16", encoder_dim=512,
                      compute_dtype="float32"),
    index=IndexConfig(dim=512, top_k=3, capacity=16),
    match=MatchConfig(image_size=S, min_score=0.15, min_overlap_pixels=16),
)
ALIGNED_CFG = CFG.replace(ground=GroundConfig(num_candidates=1024,
                                              ransac_iters=128))
DB_POSES = [(-30, -30, 0.0), (0, -30, 0.3), (30, 0, 1.6), (0, 30, 3.1)]
# near keyframes 1, 2 and 0, and one far from every keyframe
QUERIES = [(1.5, -31.0, 0.5), (31.5, -1.0, 1.8), (-28.5, -29.0, -0.2),
           (60.0, 60.0, 0.0)]
FEAT_TOL = dict(atol=1e-4, rtol=1e-3)
DESC_TOL = dict(atol=2e-4, rtol=2e-3)
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _scans(poses):
    scans = [scan_at(*p, n=N_PTS) for p in poses]
    return np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans])


def _render(poses):
    """Scans at ``poses`` → ((B, S, S, 3) BEV images, (B, 2) origins), as
    the preprocessing writes them."""
    pts, mask = _scans(poses)
    bev = batch_scan_to_bev(torch.from_numpy(pts[..., :3]),
                            torch.from_numpy(mask), CFG.bev)
    return (bev.image[..., None].repeat(1, 1, 1, 3).numpy(),
            bev.origin_xy.numpy())


def _jax_model(cfg=CFG, **kw):
    return jax_build_model(cfg.model.replace(**kw), cfg.voxel)


@pytest.fixture(scope="module")
def variables():
    """JAX's seeded variables, NetVLAD's centroids from the map's own
    normalised VGG features (alpha 30), as numpy."""
    model = _jax_model()
    images, _ = _render(DB_POSES)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    feat = np.asarray(model.apply(v, jnp.asarray(images),
                                  method=model.encode)).reshape(-1, 512)
    feat = feat / (np.linalg.norm(feat, axis=1, keepdims=True) + 1e-12)
    cents = feat[np.random.RandomState(0).permutation(len(feat))[:64]]
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"]["pool"]["centroids"] = cents.astype(np.float32)
    v["params"]["pool"]["conv_weight"] = (30.0 * cents.T).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def port_model(variables):
    model = build_model(CFG.model, CFG.voxel)
    model.load_state_dict(flax_to_state_dict(variables, "vgg16"))
    return model.eval()


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("pack_width", [True, False])
def test_vgg_feature_map_matches_jax(variables, port_model, pack_width):
    x = (np.random.RandomState(1).rand(2, 64, 64, 3) > 0.3).astype(
        np.float32)
    jm = _jax_model(vgg_pack_width=pack_width)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), method=jm.encode))
    with torch.no_grad():
        got = port_model.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 512)
    np.testing.assert_allclose(got, want, **FEAT_TOL)


def test_descriptor_matches_jax(variables, port_model):
    images, _ = _render(DB_POSES)
    want = np.asarray(_jax_model().apply(variables, jnp.asarray(images)))
    with torch.no_grad():
        got = port_model(torch.from_numpy(images)).numpy()
    assert got.shape == (4, 512)
    np.testing.assert_allclose(got, want, **DESC_TOL)


def test_conv_flops_count_the_jax_kernels(variables):
    """361 GFLOP per 768² image, from the kernel shapes of the JAX tree."""
    enc = variables["params"]["encoder"]
    total, s = 0, 768
    for i, (_, pool) in enumerate(VGG16_CFG):
        s //= 2 if pool else 1
        total += 2 * s * s * int(np.prod(enc[f"conv{i}"]["kernel"].shape))
    assert conv_flops(1, 768) == total == 360_802_418_688
    assert conv_flops(8, 128) == 8 * total // 36


def test_flax_to_state_dict_uses_the_reference_names(variables):
    sd = flax_to_state_dict(variables, "vgg16")
    enc = sorted(k for k in sd if k.startswith("encoder."))
    assert enc == sorted(f"encoder.{i}.{p}" for i in VGG16_CONV_IDX
                         for p in ("weight", "bias"))
    assert sd["encoder.0.weight"].shape == (64, 3, 3, 3)
    assert sd["encoder.28.weight"].shape == (512, 512, 3, 3)
    assert sd["pool.hidden1_weights"].shape == (64 * 512, 512)
    build_model(CFG.model, CFG.voxel).load_state_dict(sd)  # strict


@pytest.mark.parametrize("wrapped,prefixed", [(True, True), (False, False)])
def test_vggvlad_checkpoint_matches_jax(tmp_path, wrapped, prefixed):
    """A VGGVLAD checkpoint as the reference saves it loads into the port
    as it is; the same dict through the JAX package's converter and npz
    loader gives the same descriptor."""
    sys.path.insert(0, TOOLS)
    try:
        from convert_torch_checkpoint import convert_vggvlad_checkpoint
    finally:
        sys.path.remove(TOOLS)
    sd = init_params(build_model(CFG.model, CFG.voxel), seed=3).state_dict()
    ref = {("module." if prefixed else "") + k: v.clone()
           for k, v in sd.items()}
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"state_dict": ref, "epoch": 7} if wrapped else ref, path)
    loaded = load_reference_checkpoint(path)
    assert sorted(loaded) == sorted(sd)
    port = build_model(CFG.model, CFG.voxel)
    port.load_state_dict(loaded)

    npz = str(tmp_path / "vggvlad.npz")
    np.savez(npz, **convert_vggvlad_checkpoint(ref))
    jm = _jax_model()
    images, _ = _render(DB_POSES[:2])
    init = jax.jit(jm.init)(jax.random.PRNGKey(9), jnp.asarray(images[:1]))
    params = load_vggvlad_npz(jax.tree_util.tree_map(np.asarray,
                                                     init["params"]), npz)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(images)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, **DESC_TOL)
    # and back: the JAX tree through flax_to_state_dict is the checkpoint
    back = flax_to_state_dict({"params": params}, "vgg16")
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_init_vlad_from_images(port_model):
    """NetVLAD's data init takes BEV images without masks (cluster mode on
    the VGG feature map)."""
    model = build_model(CFG.model, CFG.voxel)
    model.load_state_dict(port_model.state_dict())
    images, _ = _render(DB_POSES)
    cents, descs = init_vlad_from_data(
        CFG, model, images, None, torch.Generator().manual_seed(0),
        num_images=4, per_image=16)
    assert cents.shape == (64, 512) and descs.shape == (64, 512)
    torch.testing.assert_close(descs.norm(dim=1), torch.ones(64))
    torch.testing.assert_close(model.pool.centroids, cents)


# ---------------------------------------------------------------- pipeline
def _same(got, want, xy_tol, pose_tol):
    assert got.success == want.success
    assert got.db_index == want.db_index
    np.testing.assert_array_equal(got.candidates, want.candidates)
    assert got.match_score == pytest.approx(want.match_score, abs=1e-3)
    if want.success:
        np.testing.assert_allclose(got.match_xy_yaw,
                                   np.asarray(want.match_xy_yaw), atol=xy_tol)
        np.testing.assert_allclose(got.pose.translation,
                                   np.asarray(want.pose.translation),
                                   atol=pose_tol)
        np.testing.assert_allclose(got.pose.rotation,
                                   np.asarray(want.pose.rotation),
                                   atol=pose_tol)


def _vs_jax(got, want):
    _same(got, want, xy_tol=1e-4, pose_tol=1e-3)


def _vs_port(got, want):
    _same(got, want, xy_tol=1e-5, pose_tol=1e-5)


@pytest.fixture(scope="module")
def scan_maps(variables, port_model):
    """The map of DB_POSES from scans in both packages."""
    pts, mask = _scans(DB_POSES)
    ref = JaxLocalizer(CFG, _jax_model(), variables)
    port = GlobalLocalizer(CFG, port_model, device="cpu")
    ref.add_keyframes(pts, mask)
    port.add_keyframes(pts, mask)
    return ref, port


def test_detect_on_scans_matches_jax(scan_maps):
    ref, port = scan_maps
    for a, b in zip(port.keyframes, ref.keyframes):
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.origin_xy, b.origin_xy)
    np.testing.assert_allclose(port.bank.data.numpy(),
                               np.asarray(ref.bank.data), **DESC_TOL)
    pts, mask = _scans(QUERIES)
    d_t, i_t, bev_t, g_t = port.detect(pts, mask)
    d_j, i_j, bev_j, g_j = ref.detect(pts, mask)
    assert g_t is None and g_j is None
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(d_t, d_j, atol=1e-3, rtol=2e-3)
    np.testing.assert_array_equal(bev_t.image.numpy(), np.asarray(bev_j.image))
    np.testing.assert_array_equal(i_t[:3, 0], [1, 2, 0])


@pytest.mark.parametrize("q_pose", QUERIES)
def test_locate_on_scans_matches_jax(scan_maps, q_pose):
    ref, port = scan_maps
    pts, mask = scan_at(*q_pose, n=N_PTS)
    want = ref.locate(pts, mask)
    _vs_jax(port.locate(pts, mask), want)


@pytest.fixture(scope="module")
def image_maps(variables, port_model):
    """The map of DB_POSES from BEV images: JAX with its device store (it
    serves locate, locate_batch and locate_fused), the port with its host
    mirror, with the store and a mirror, and with the store alone."""
    images, origins = _render(DB_POSES)
    ref = JaxLocalizer(CFG, _jax_model(), variables, device_keyframes=True)
    ref.add_keyframes(images, origins=origins)
    ports = {}
    for name, kw in (("host mirror", {}),
                     ("store", dict(device_keyframes=True)),
                     ("store, no mirror", dict(device_keyframes=True,
                                               host_mirror=False))):
        loc = GlobalLocalizer(CFG, port_model, device="cpu", **kw)
        loc.add_keyframes(images[:2], origins=origins[:2])
        loc.add_keyframes(images[2:], origins=origins[2:])
        ports[name] = loc
    q_images, q_origins = _render(QUERIES)
    return ref, ports, q_images, q_origins


@pytest.mark.parametrize("store", ["host mirror", "store",
                                   "store, no mirror"])
def test_image_locate_matches_jax(image_maps, store):
    ref, ports, q_images, q_origins = image_maps
    loc = ports[store]
    assert len(loc.keyframes) == len(loc.bank) == 4
    assert all((k.image is None) == (store == "store, no mirror")
               for k in loc.keyframes)
    n_success = 0
    for img, org in zip(q_images, q_origins):
        want = ref.locate(img, origin=org)
        _vs_jax(loc.locate(img, origin=org), want)
        n_success += want.success
    assert n_success >= 3


def test_image_extract_matches_jax(image_maps):
    ref, ports, q_images, q_origins = image_maps
    d_j, bev_j, g_j = ref.extract(q_images, origins=q_origins)
    d_t, bev_t, g_t = ports["store"].extract(q_images, origins=q_origins)
    assert g_j is None and g_t is None
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **DESC_TOL)
    np.testing.assert_array_equal(bev_t.image.numpy(), np.asarray(bev_j.image))
    np.testing.assert_array_equal(bev_t.origin_xy.numpy(),
                                  np.asarray(bev_j.origin_xy))
    np.testing.assert_array_equal(bev_t.num_occupied.numpy(),
                                  np.asarray(bev_j.num_occupied))
    # default origins: scan-centred
    _, bev_d, _ = ports["store"].extract(q_images[:1])
    np.testing.assert_array_equal(bev_d.origin_xy.numpy(),
                                  np.full((1, 2), -S / 2 * 0.2, np.float32))


@pytest.mark.parametrize("call", ["locate_batch", "locate_fused"])
def test_batch_and_fused_image_queries(image_maps, call):
    """locate_batch and locate_fused on image queries equal the port's
    locate and JAX's same call."""
    ref, ports, q_images, q_origins = image_maps
    loc = ports["store, no mirror"]
    want_port = [loc.locate(i, origin=o) for i, o in zip(q_images, q_origins)]
    if call == "locate_batch":
        got = loc.locate_batch(q_images, origins=q_origins)
        want = ref.locate_batch(q_images, origins=q_origins)
    else:
        got = [loc.locate_fused(i, origin=o)
               for i, o in zip(q_images, q_origins)]
        want = [ref.locate_fused(i, origin=o)
                for i, o in zip(q_images, q_origins)]
    assert any(r.success for r in want) and not all(r.success for r in want)
    for g, wp, w in zip(got, want_port, want):
        _vs_port(g, wp)
        _vs_jax(g, w)


def test_jax_i2i_map_loads_in_the_port(image_maps, port_model, tmp_path):
    ref, ports, q_images, q_origins = image_maps
    ref.save(str(tmp_path))
    loc = GlobalLocalizer(CFG, port_model, device="cpu",
                          device_keyframes=True, host_mirror=False)
    loc.load(str(tmp_path))
    np.testing.assert_array_equal(loc.bank.data.numpy(),
                                  np.asarray(ref.bank.data))
    for img, org in zip(q_images, q_origins):
        _vs_jax(loc.locate(img, origin=org), ref.locate(img, origin=org))


def test_port_i2i_map_loads_in_jax(image_maps, variables, tmp_path):
    ref, ports, q_images, q_origins = image_maps
    src = ports["store, no mirror"]
    src.save(str(tmp_path))
    loc = JaxLocalizer(CFG, _jax_model(), variables)
    loc.load(str(tmp_path))
    for a, b in zip(loc.keyframes, ports["host mirror"].keyframes):
        np.testing.assert_array_equal(a.image, b.image)
    for img, org in zip(q_images[:2], q_origins[:2]):
        _vs_jax(src.locate(img, origin=org), loc.locate(img, origin=org))


# ---------------------------------------------------------------- aligned
class _JaxDraws:
    """The JAX localizer's ground-estimator draws, replayed into the port:
    each extract splits the localizer's key and then one key per scan
    (``GlobalLocalizer._align_impl``); each scan's estimate takes that
    key's draws (tests/test_torch_ground.py::_replayed_draws), fed to the
    port's one batched estimate through ``_align``'s stacked ``draws``."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def attach(self, loc, monkeypatch):
        align = loc._align

        def replayed_align(points, mask):
            self.key, sub = jax.random.split(self.key)
            draws = [_replayed_draws(k, points.shape[1])
                     for k in jax.random.split(sub, points.shape[0])]

            def sample_triplets(ground_ok, h):
                return torch.stack([sampler(ok, h) for (_, sampler), ok
                                    in zip(draws, ground_ok)])

            return align(points, mask, (torch.stack([p for p, _ in draws]),
                                        sample_triplets))

        monkeypatch.setattr(loc, "_align", replayed_align)


ALIGNED_DB = [(-30, -30, 0.0), (0, -30, 0.4), (30, 0, 1.5)]
ALIGNED_TILTS = [(0.02, -0.01), (-0.015, 0.02), (0.01, 0.015)]


def test_aligned_locate_matches_jax(variables, port_model, monkeypatch):
    """The paper's configuration, aligned scan → BEV → VGG → 6-DoF, with
    the port replaying JAX's ground draws."""
    # scan seeds 10-12 (the estimator's own parity on these scans, at
    # seeds 0-2 and 12 too, is tests/test_torch_ground.py's)
    scans = [tilted_scan(*p, roll=r, pitch=pi, seed=10 + i)
             for i, (p, (r, pi)) in enumerate(zip(ALIGNED_DB, ALIGNED_TILTS))]
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    ref = JaxLocalizer(ALIGNED_CFG, _jax_model(ALIGNED_CFG), variables,
                       align_ground=True, seed=4)
    port = GlobalLocalizer(ALIGNED_CFG, port_model, device="cpu",
                           align_ground=True)
    _JaxDraws(4).attach(port, monkeypatch)
    ref.add_keyframes(pts, mask)
    port.add_keyframes(pts, mask)
    for a, b in zip(port.keyframes, ref.keyframes):
        np.testing.assert_allclose(a.ground.rotation,
                                   np.asarray(b.ground.rotation), atol=1e-4)
        np.testing.assert_allclose(a.ground.translation,
                                   np.asarray(b.ground.translation),
                                   atol=1e-4)
    q = tilted_scan(2.5, -31.5, 0.7, roll=0.03, pitch=-0.02, height=1.65,
                    seed=99)
    got, want = port.locate(*q), ref.locate(*q)
    assert want.success and want.db_index == 1
    _vs_jax(got, want)
    assert abs(float(got.pose.translation[2]) + 0.05) < 0.3


# ---------------------------------------------------------------- guards
def test_image_encoder_drops_host_stats(port_model):
    loc = GlobalLocalizer(CFG, port_model, device="cpu", host_stats=True)
    assert loc.host_stats is False and loc.i2i


def test_images_need_an_image_encoder():
    s2s = CFG.replace(model=ModelConfig(encoder="pointpillar",
                                        encoder_dim=128,
                                        compute_dtype="float32"),
                      index=IndexConfig(dim=128, top_k=3))
    loc = GlobalLocalizer(s2s, build_model(s2s.model, s2s.voxel),
                          device="cpu")
    with pytest.raises(ValueError, match="image encoder"):
        loc.extract(np.ones((1, S, S, 3), np.float32))


def test_trainer_refuses_image_encoders(port_model, tmp_path):
    """The Trainer no longer refuses an image encoder: on the rendered BEVs
    it takes a step with masks None under the VGG16 freeze mask, which
    leaves conv0-9 bit-unchanged (tests/test_torch_train_i2i.py holds the
    step to JAX's)."""
    import copy

    from gloc3d_tpu_torch.data.dataset import TripletDataset
    from gloc3d_tpu_torch.models.encoders import train_mask
    from gloc3d_tpu_torch.train import Trainer

    images, _ = _render(DB_POSES[:2])
    ds = TripletDataset(db_inputs=images, q_inputs=images[:1],
                        utm_db=np.zeros((2, 2)), utm_q=np.zeros((1, 2)))
    cfg = CFG.replace(train=CFG.train.replace(n_neg=1, batch_size=1,
                                              margin=10.0))
    model = copy.deepcopy(port_model).train()
    tr = Trainer(cfg, model, ds, str(tmp_path), device="cpu",
                 trainable_mask=train_mask(model, "vgg16"))
    before = model.encoder[0].weight.detach().clone()
    loss = tr.train_step(images[:1], None, images[:1], None, images[1:2],
                         None, np.ones((1, 1), np.float32),
                         np.ones(1, np.float32))
    assert np.isfinite(float(loss)) and tr.step == 1 and not tr.host_stats
    assert torch.equal(model.encoder[0].weight, before)
    assert model.encoder[28].weight.grad is not None
