"""The i2i encoder baselines (AlexNet, MobileNetV2, ResNet18) in the port
against the JAX package, in fp32 and eval mode, on 96² images.

Weights: JAX's seeded init with random BatchNorm running statistics,
carried into the port by ``flax_to_state_dict`` (through the inverse of
``convert_torchvision_encoder``). Tolerances: feature maps atol 1e-4 / rtol
1e-3, descriptors atol 2e-4 / rtol 2e-3, as for VGG16
(tests/test_torch_i2i.py); the converters exactly. ``l2_normalize_output``
on all four encoders at 64²: norms within 1e-5 of 1, features as the
feature maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import ModelConfig, VoxelConfig
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.models import encoders as jax_encoders
from gloc3d_tpu.models.encoders import convert_torchvision_encoder
from gloc3d_tpu.models.vgg import VGG16Encoder as JaxVGG16Encoder
from gloc3d_tpu_torch.config import ENCODER_DIMS
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.models.encoders import (
    build_image_encoder, port_key, torchvision_state_dict,
)
from gloc3d_tpu_torch.models.vgg import VGG16_CONV_IDX
from test_torch_threads import _two_threads  # noqa: F401


NAMES = ["alexnet", "mobilenet", "resnet18"]
SIZE = 96
MAP = {"alexnet": 5, "mobilenet": 3, "resnet18": 3}  # feature map side


def _cfg(name):
    return ModelConfig(encoder=name, encoder_dim=ENCODER_DIMS[name],
                       compute_dtype="float32")


def _images(seed=0, n=2):
    return (np.random.RandomState(seed).rand(n, SIZE, SIZE, 3) > 0.2
            ).astype(np.float32)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """(name, JAX model, its numpy variables with random BN statistics,
    the port model carrying the same weights)."""
    name = request.param
    jm = jax_build_model(_cfg(name), VoxelConfig())
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.asarray(_images(n=1))))
    rng = np.random.RandomState(2)
    for node in v.get("batch_stats", {}).get("encoder", {}).values():
        node["mean"] = (0.1 * rng.randn(*node["mean"].shape)).astype(
            np.float32)
        node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(
            np.float32)
    port = build_model(_cfg(name), VoxelConfig())
    port.load_state_dict(flax_to_state_dict(v, name))
    return name, jm, v, port.eval()


def test_feature_map_matches_jax(pair):
    name, jm, v, port = pair
    x = _images(seed=3)
    want = np.asarray(jm.apply(v, jnp.asarray(x), method=jm.encode))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x)).numpy()
    side = MAP[name]
    assert got.shape == want.shape == (2, side, side, ENCODER_DIMS[name])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_descriptor_matches_jax(pair):
    _, jm, v, port = pair
    x = _images(seed=4)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_torchvision_names_round_trip_through_jax(pair):
    """torchvision_state_dict is the inverse of the JAX package's
    convert_torchvision_encoder, and the port's module names are the
    reference's Sequential of the truncated backbone."""
    name, _, v, port = pair
    enc_p = v["params"]["encoder"]
    enc_s = v.get("batch_stats", {}).get("encoder", {})
    tv = torchvision_state_dict(name, enc_p, enc_s)
    params, stats = convert_torchvision_encoder(name, tv)
    assert sorted(params) == sorted(enc_p) and sorted(stats) == sorted(enc_s)
    for tree, ref in ((params, enc_p), (stats, enc_s)):
        for layer, leaves in ref.items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(tree[layer][leaf], value)
    own = build_image_encoder(name, torch.float32).state_dict()
    assert sorted(own) == sorted(port_key(name, k) for k in tv)


def _l2_pair_close(got, want):
    """``l2_normalize_output=True``: unit norms over channels within 1e-5,
    features within the file's feature-map tolerance."""
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_l2_normalize_output_matches_jax(pair):
    """The encoder alone with ``l2_normalize_output=True`` on 64² images,
    the pair's weights on both sides."""
    name, _, v, port = pair
    x = (np.random.RandomState(5).rand(2, 64, 64, 3) > 0.2).astype(
        np.float32)
    enc = jax_encoders.build_image_encoder(name, jnp.float32,
                                           l2_normalize_output=True)
    ev = {"params": v["params"]["encoder"]}
    if "batch_stats" in v:
        ev["batch_stats"] = v["batch_stats"]["encoder"]
    want = np.asarray(jax.jit(enc.apply)(ev, jnp.asarray(x)))
    own = build_image_encoder(name, torch.float32, l2_normalize_output=True)
    own.load_state_dict(port.encoder.state_dict())
    with torch.no_grad():
        got = own.eval()(torch.from_numpy(x)).numpy()
    _l2_pair_close(got, want)


def test_vgg16_l2_normalize_output_matches_jax():
    """VGG16 with ``l2_normalize_output=True`` at 64², JAX's seeded init
    carried onto the port's conv indices."""
    x = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32)
    enc = JaxVGG16Encoder(compute_dtype=jnp.float32,
                          l2_normalize_output=True, pack_width=False)
    params = jax.jit(enc.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(x)))
    state = {}
    for i, li in enumerate(VGG16_CONV_IDX):
        conv = params["params"][f"conv{i}"]
        state[f"{li}.weight"] = torch.from_numpy(np.array(
            conv["kernel"])).permute(3, 2, 0, 1).contiguous()
        state[f"{li}.bias"] = torch.from_numpy(np.array(conv["bias"]))
    own = build_image_encoder("vgg16", torch.float32,
                              l2_normalize_output=True)
    own.load_state_dict(state)
    with torch.no_grad():
        got = own(torch.from_numpy(x)).numpy()
    _l2_pair_close(got, want)


def test_resnet18_port_keys():
    assert port_key("resnet18", "conv1.weight") == "0.weight"
    assert port_key("resnet18", "bn1.running_var") == "1.running_var"
    assert (port_key("resnet18", "layer3.0.downsample.1.weight")
            == "6.0.downsample.1.weight")
    assert port_key("alexnet", "features.10.bias") == "10.bias"
