"""The rest of the JAX package's public surface in the port: every name
that the JAX package's subpackage ``__init__`` files export imports from
the port's counterpart (each loading on first use), but a listed few, each
with its reason; and the four functions that had no counterpart, held to
JAX: ``core/transforms.py::get_angle`` and ``project_2d``,
``ops/voxelize.py::pad_or_trim`` and ``models/vgg.py::
load_torchvision_npz`` (onto the port's VGG parameter names)."""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.core import transforms as jax_tf
from gloc3d_tpu.models import vgg as jax_vgg
from gloc3d_tpu.ops.voxelize import pad_or_trim as jax_pad_or_trim
from gloc3d_tpu_torch.core import Rigid3, get_angle, project_2d
from gloc3d_tpu_torch.models import VGG16Encoder
from gloc3d_tpu_torch.models.vgg import VGG16_CONV_IDX, load_torchvision_npz
from gloc3d_tpu_torch.ops import pad_or_trim
from test_torch_threads import _two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("core", "ops", "models", "index", "data", "train", "parallel",
               "eval")
LEFT_OUT = {
    ("train", "TrainState"): "JAX's optimizer-state NamedTuple; the port's "
    "Trainer holds a torch.optim optimizer and its step count",
    ("parallel", "shard_batch"): "places a JAX array on a mesh; each rank "
    "of a process group holds its own tensors",
    ("parallel", "replicate"): "places a JAX array on a mesh; each rank of "
    "a process group holds its own tensors",
}


def jax_exports(package):
    """The names the JAX package's ``<package>/__init__.py`` imports."""
    path = os.path.join(REPO, "gloc3d_tpu", package, "__init__.py")
    tree = ast.parse(open(path).read())
    return sorted(a.asname or a.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("package", SUBPACKAGES)
def test_every_exported_name_imports_from_the_port(package):
    names = jax_exports(package)
    assert names
    port = importlib.import_module(f"gloc3d_tpu_torch.{package}")
    missing = [n for n in names if (package, n) not in LEFT_OUT
               and not hasattr(port, n)]
    assert not missing, missing
    for (pkg, name), why in LEFT_OUT.items():
        if pkg == package:  # the list stays true: each is exported by JAX
            assert name in names and not hasattr(port, name), (name, why)


def test_exports_are_the_same_objects_as_their_modules():
    from gloc3d_tpu_torch.core import transforms
    from gloc3d_tpu_torch.index import bank
    from gloc3d_tpu_torch.models import build_model, descriptor, losses

    from gloc3d_tpu_torch.core import Rigid2
    from gloc3d_tpu_torch.index import DescriptorBank

    assert Rigid2 is transforms.Rigid2
    assert DescriptorBank is bank.DescriptorBank
    assert build_model is descriptor.build_model
    assert losses.__name__ == "gloc3d_tpu_torch.models.losses"
    with pytest.raises(AttributeError):
        importlib.import_module("gloc3d_tpu_torch.ops").not_a_name


def _quats(n, seed):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = [1, 0, 0, 0]       # identity
    q[1] = [-0.6, 0, 0, 0.8]  # negative w
    return q


def test_get_angle_and_project_2d_match_jax():
    q = _quats(64, 0)
    t = np.random.RandomState(1).randn(64, 3).astype(np.float32) * 10
    np.testing.assert_allclose(get_angle(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_tf.get_angle(jnp.asarray(q))),
                               atol=1e-6)
    got = project_2d(Rigid3(torch.from_numpy(q), torch.from_numpy(t)))
    want = jax_tf.project_2d(jax_tf.Rigid3(jnp.asarray(q), jnp.asarray(t)))
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle),
                               atol=1e-6)
    np.testing.assert_array_equal(got.translation.numpy(),
                                  np.asarray(want.translation))


@pytest.mark.parametrize("rows,cols,num,dims,pad_val", [
    (5, 4, 8, None, 0.0), (12, 4, 8, None, 0.0), (5, 4, 8, 6, -1.0),
    (5, 4, 3, 2, 0.0), (0, 3, 4, None, 7.0)])
def test_pad_or_trim_matches_jax(rows, cols, num, dims, pad_val):
    x = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    got = pad_or_trim(x, num, dims, pad_val)
    want = jax_pad_or_trim(x, num, dims, pad_val)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_load_torchvision_npz_matches_jax(tmp_path):
    """One converted .npz (random weights, the 13 convs' shapes) loaded by
    both: the port's convs equal JAX's kernels on the reference's names,
    and both encoders give the same fp32 features on a 32² image."""
    rng = np.random.RandomState(0)
    model = jax_vgg.VGG16Encoder(compute_dtype=jnp.float32, pack_width=False)
    x = rng.rand(1, 32, 32, 3).astype(np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    data = {}
    for i in range(len(VGG16_CONV_IDX)):
        k = shapes[f"conv{i}"]["kernel"].shape
        data[f"conv{i}_kernel"] = (rng.randn(*k) / np.sqrt(
            k[0] * k[1] * k[2])).astype(np.float32)
        data[f"conv{i}_bias"] = rng.randn(k[3]).astype(np.float32) * 0.1
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **data)
    params = jax_vgg.load_torchvision_npz(
        {f"conv{i}": {} for i in range(len(VGG16_CONV_IDX))}, path)
    enc = load_torchvision_npz(VGG16Encoder(torch.float32), path)
    sd = enc.state_dict()
    for i, li in enumerate(VGG16_CONV_IDX):
        np.testing.assert_array_equal(
            sd[f"{li}.weight"].permute(2, 3, 1, 0).numpy(),
            np.asarray(params[f"conv{i}"]["kernel"]))
        np.testing.assert_array_equal(sd[f"{li}.bias"].numpy(),
                                      np.asarray(params[f"conv{i}"]["bias"]))
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
