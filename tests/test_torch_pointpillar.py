"""convert.py + PointPillar / NetVLAD / DescriptorModel: the port against the
Flax model at compute_dtype float32, with the JAX package's own initialised
weights bridged into the port, for both fold_bn variants.

Descriptor tolerance atol 2e-4 / rtol 2e-3: the bound
tests/test_pipeline_hoststats.py holds between two JAX paths (fp32 sums and
convolutions in another order)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gloc3d_tpu.config import ModelConfig, VoxelConfig
from gloc3d_tpu.data.native import compute_voxel_stats_host_sorted
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.models.fold import fold_batch_norm as jax_fold
from gloc3d_tpu.models.netvlad import NetVLAD as JaxNetVLAD
from gloc3d_tpu_torch.convert import (
    flax_to_state_dict, fold_batch_norm, netvlad_state_dict,
)
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.models.netvlad import NetVLAD
from gloc3d_tpu_torch.models.pointpillar import _pad_same, conv_bn_act
from test_pipeline import scan_at
from test_torch_threads import _two_threads  # noqa: F401


N_PTS = 2048
VC = VoxelConfig(max_points=N_PTS)
MC = ModelConfig(encoder="pointpillar", encoder_dim=128,
                 compute_dtype="float32")
DESC_TOL = dict(atol=2e-4, rtol=2e-3)


def _inputs():
    scans = [scan_at(3, -5, 0.7, n=N_PTS), scan_at(-10, 12, 2.5, n=N_PTS)]
    pts = np.stack([s[0] for s in scans])
    counts = np.asarray([s[1].sum() for s in scans], np.int64)
    p, v, i, c, g, s, pp = compute_voxel_stats_host_sorted(
        pts, counts, VC.xbound, VC.ybound, VC.zbound, crop=False,
        per_point=True)
    return p, v, (i, c, g, s, pp)


def _randomize_bn_stats(variables, seed=1):
    """Non-trivial running statistics, so the BN fold is exercised."""
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(np.array, variables["batch_stats"])

    def fill(node):
        for k, val in node.items():
            if isinstance(val, dict):
                fill(val)
            elif k == "mean":
                node[k] = (0.1 * rng.randn(*val.shape)).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
    fill(stats)
    return {"params": variables["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_model():
    p, v, vs = _inputs()
    model = jax_build_model(MC, VC)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(p), jnp.asarray(v),
        voxel_stats=tuple(jnp.asarray(a) for a in vs))
    return model, _randomize_bn_stats(variables)


def _port_desc(mc, state_dict, p, v, vs, fn="forward"):
    model = build_model(mc, VC)
    model.load_state_dict(state_dict)
    model.eval()
    with torch.no_grad():
        args = (torch.from_numpy(p), torch.from_numpy(v))
        stats = tuple(torch.from_numpy(a) for a in vs)
        if fn == "encoder":
            return model.encoder(*args, voxel_stats=stats).numpy()
        return model(*args, voxel_stats=stats).numpy()


@pytest.mark.parametrize("fold", [False, True])
def test_descriptor_matches_flax(jax_model, fold):
    p, v, vs = _inputs()
    model, variables = jax_model
    if fold:
        model = jax_build_model(MC.replace(fold_bn=True), VC)
        variables = {"params": jax_fold(variables["params"],
                                        variables["batch_stats"])}
    want = np.asarray(model.apply(variables, jnp.asarray(p), jnp.asarray(v),
                                  voxel_stats=tuple(map(jnp.asarray, vs))))
    got = _port_desc(MC.replace(fold_bn=fold),
                     flax_to_state_dict(variables), p, v, vs)
    assert got.shape == want.shape == (2, 128)
    np.testing.assert_allclose(got, want, **DESC_TOL)


@pytest.mark.parametrize("fold", [False, True])
def test_device_binning_descriptor_matches_flax(jax_model, fold):
    """voxel_stats=None: the pillar statistics and the feature mean bin on
    the device (K2's plain version here, the XLA scatter in JAX), on the
    unsorted scans in their original row order."""
    model, variables = jax_model
    if fold:
        model = jax_build_model(MC.replace(fold_bn=True), VC)
        variables = {"params": jax_fold(variables["params"],
                                        variables["batch_stats"])}
    scans = [scan_at(3, -5, 0.7, n=N_PTS), scan_at(-10, 12, 2.5, n=N_PTS)]
    pts = np.stack([s[0] for s in scans])
    mask = np.stack([s[1] for s in scans])
    want = np.asarray(model.apply(variables, jnp.asarray(pts),
                                  jnp.asarray(mask)))
    port = build_model(MC.replace(fold_bn=fold), VC)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(pts),
                          torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 128)
    np.testing.assert_allclose(got, want, **DESC_TOL)


def test_encoder_feature_map_matches_flax(jax_model):
    """The PointPillar output keeps the JAX layout (B, gy, gx, 128)."""
    p, v, vs = _inputs()
    model, variables = jax_model
    want = np.asarray(model.apply(
        variables, jnp.asarray(p), jnp.asarray(v),
        voxel_stats=tuple(map(jnp.asarray, vs)),
        method=lambda m, *a, **k: m.encode(*a, **k)))
    got = _port_desc(MC, flax_to_state_dict(variables), p, v, vs,
                     fn="encoder")
    assert got.shape == want.shape == (2, 80, 140, 128)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)


def test_port_fold_equals_jax_fold(jax_model):
    """fold(convert(tree)) == convert(jax_fold(tree)), bit for bit."""
    _, variables = jax_model
    mine = fold_batch_norm(flax_to_state_dict(variables))
    theirs = flax_to_state_dict({"params": jax_fold(
        variables["params"], variables["batch_stats"])})
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k].numpy(),
                                      err_msg=k)


def test_state_dict_uses_reference_names(jax_model):
    sd = flax_to_state_dict(jax_model[1])
    for key, shape in (("encoder.pn.pointnet.0.weight", (64, 14, 1)),
                       ("encoder.block1.layers.3.weight", (64, 64, 3, 3)),
                       ("encoder.block2.layers.0.weight", (128, 64, 3, 3)),
                       ("encoder.up2.1.weight", (128, 128, 3, 3)),
                       ("encoder.conv_out.3.weight", (128, 256, 3, 3)),
                       ("encoder.conv_out.4.running_var", (128,)),
                       ("pool.conv.weight", (64, 128, 1, 1)),
                       ("pool.centroids", (64, 128)),
                       ("pool.hidden1_weights", (64 * 128, 128))):
        assert tuple(sd[key].shape) == shape, key
    # and the port's module tree has exactly these entries
    assert set(build_model(MC, VC).state_dict()) == set(sd)


def test_stride2_same_padding_trap():
    """Flax SAME pads a stride-2 3×3 conv (0 low, 1 high); torch's
    padding=1 pads (1, 1) and lands on a grid shifted by one cell."""
    x = np.random.RandomState(0).randn(1, 140, 80, 8).astype(np.float32)
    conv = fnn.Conv(16, (3, 3), strides=(2, 2), padding="SAME",
                    use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x))).transpose(0, 3, 1, 2)
    tconv = torch.nn.Conv2d(8, 16, 3, stride=2, padding=0, bias=False)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.array(
            params["params"]["kernel"]).transpose(3, 2, 0, 1)))
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
        assert _pad_same(xt, 3, 2).shape[-2:] == (141, 81)
        got = conv_bn_act(xt, tconv, torch.nn.Identity(), True,
                          torch.float32)
        naive = F.relu(F.conv2d(xt, tconv.weight, stride=2, padding=1))
    assert got.shape == naive.shape == (1, 16, 70, 40)
    np.testing.assert_allclose(got.numpy(), np.maximum(want, 0), atol=1e-5)
    assert np.abs(naive.numpy() - np.maximum(want, 0)).max() > 0.1


@pytest.mark.parametrize("vladv2,gating,normalize_input,use_fc", [
    (False, False, True, True), (True, False, True, True),
    (False, True, True, True), (False, False, False, False),
])
def test_netvlad_variants_match_flax(vladv2, gating, normalize_input, use_fc):
    k, d = 8, 16
    x = np.random.RandomState(1).randn(2, 5, 7, d).astype(np.float32)
    ref = JaxNetVLAD(num_clusters=k, dim=d, vladv2=vladv2, gating=gating,
                     normalize_input=normalize_input, use_fc=use_fc)
    variables = ref.init(jax.random.PRNGKey(3), jnp.asarray(x))
    if vladv2:  # non-zero assignment bias
        variables = jax.tree.map(np.asarray, variables)
        variables["params"]["conv_bias"] = np.linspace(
            -1, 1, k).astype(np.float32)
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    port = NetVLAD(num_clusters=k, dim=d, vladv2=vladv2, gating=gating,
                   normalize_input=normalize_input, use_fc=use_fc).eval()
    port.load_state_dict(netvlad_state_dict(
        variables["params"], variables.get("batch_stats")))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_pooling_heads_match_flax(pooling):
    p, v, vs = _inputs()
    mc = MC.replace(pooling=pooling)
    model = jax_build_model(mc, VC)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(p), jnp.asarray(v),
        voxel_stats=tuple(map(jnp.asarray, vs)))
    want = np.asarray(model.apply(variables, jnp.asarray(p), jnp.asarray(v),
                                  voxel_stats=tuple(map(jnp.asarray, vs))))
    got = _port_desc(mc, flax_to_state_dict(variables), p, v, vs)
    np.testing.assert_allclose(got, want, **DESC_TOL)


def test_seeded_init_is_deterministic_and_finite():
    p, v, vs = _inputs()
    mc = MC.replace(fold_bn=True)
    a = init_params(build_model(mc, VC), seed=7).state_dict()
    b = init_params(build_model(mc, VC), seed=7).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    desc = _port_desc(mc, a, p, v, vs)
    assert desc.shape == (2, 128) and np.isfinite(desc).all()
    assert np.abs(desc[0] - desc[1]).max() > 1e-3  # the two scans differ
