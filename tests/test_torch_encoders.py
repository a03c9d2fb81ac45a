"""The i2i encoder baselines (AlexNet, MobileNetV2, ResNet18) in the port
against the JAX package, in fp32 and eval mode, on 96² images.

Weights: JAX's seeded init with random BatchNorm running statistics,
carried into the port by ``flax_to_state_dict`` (through the inverse of
``convert_torchvision_encoder``). Tolerances: feature maps atol 1e-4 / rtol
1e-3, descriptors atol 2e-4 / rtol 2e-3, as for VGG16
(tests/test_torch_i2i.py); the converters exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import ModelConfig, VoxelConfig
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.models.encoders import convert_torchvision_encoder
from gloc3d_tpu_torch.config import ENCODER_DIMS
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.models.encoders import (
    build_image_encoder, port_key, torchvision_state_dict,
)
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


def test_resnet18_port_keys():
    assert port_key("resnet18", "conv1.weight") == "0.weight"
    assert port_key("resnet18", "bn1.running_var") == "1.running_var"
    assert (port_key("resnet18", "layer3.0.downsample.1.weight")
            == "6.0.downsample.1.weight")
    assert port_key("alexnet", "features.10.bias") == "10.bias"
