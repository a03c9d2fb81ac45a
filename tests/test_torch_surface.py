"""The rest of the JAX package's public surface in the port: every name
that the JAX package's subpackage ``__init__`` files export imports from
the port's counterpart (each loading on first use), but a listed few, each
with its reason; and the four functions that had no counterpart, held to
JAX: ``core/transforms.py::get_angle`` and ``project_2d``,
``ops/voxelize.py::pad_or_trim`` and ``models/vgg.py::
load_torchvision_npz`` (onto the port's VGG parameter names).

The walk (``test_public_surface_matches_jax``) goes one level further, over
every class and function those ``__init__`` files export, the public
functions of an exported module (``models.losses``), ``pipeline``'s
``GlobalLocalizer`` and ``LocalizationResult``, and every public class and
function of ``models/encoders.py``, ``export.py`` and ``config.py``:

- the port's object is of the same kind (a function for a function: a
  package name that is also a submodule's must not load as the module);
- every public method, static method and operator of a JAX class has a
  counterpart on the port's class (Flax ``__call__`` → ``forward``,
  ``setup`` → ``__init__``);
- every parameter of a JAX function, method or constructor, and every
  field of a Flax module, NamedTuple or dataclass, has a parameter or field
  of the same name in the port.

What the port leaves out stands in ``LEFT_OUT``, ``METHODS_LEFT_OUT`` and
``PARAMS_LEFT_OUT`` with its reason, and the walk's gaps must equal those
tables exactly: an unlisted gap fails, and so does an entry that JAX no
longer has or that the port has gained."""

import ast
import dataclasses
import importlib
import inspect
import os
import types

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
    ("models.encoders", "convert_torchvision_encoder"): "builds Flax trees "
    "from a torchvision state_dict; the port's encoders hold torchvision's "
    "own layout, so {port_key(name, k): v} loads one as it is",
}
METHODS_LEFT_OUT = {
    "train.Trainer.init_state": "builds JAX's TrainState; the port's "
    "Trainer holds its model, optimizer and step from construction",
    "export.ExportedDescriptorModel.apply": "the exported module is called: "
    "its __call__ takes the inputs as apply takes them after the variables",
}
_FLAX_CALLS = ("models.DescriptorModel.__call__",
               "models.DescriptorModel.encode",
               "models.GatingContext.__call__",
               "models.NetVLAD.__call__", "models.PillarBlock.__call__",
               "models.PointNet.__call__", "models.PointPillar.__call__",
               "models.VGG16Encoder.__call__",
               "models.encoders.AlexNetEncoder.__call__",
               "models.encoders.MobileNetV2Encoder.__call__",
               "models.encoders.ResNet18Encoder.__call__")
PARAMS_LEFT_OUT = {  # name → (reason, the owners JAX has it on)
    "key": ("a JAX PRNG key: the port takes a torch.Generator or injected "
            "draws, as torch cannot replay JAX's PRNG",
            ("index.IVFBank.train", "index.kmeans", "train.mine_triplets",
             "train.init_vlad_from_data")),
    "train": ("Flax's training flag: a torch module's mode is .train() / "
              ".eval()", _FLAX_CALLS),
    "params": ("a Flax parameter tree: the port's module holds its "
               "parameters", ("models.init_netvlad_params",
                              "train.init_vlad_from_data",
                              "models.encoders.encoder_trainable_mask",
                              "export.export_descriptor_model")),
    "path": ("the NetVLAD's key path inside a Flax parameter tree: the port "
             "takes the module", ("models.init_netvlad_params",)),
    "state": ("JAX's TrainState: the port's Trainer holds its state",
              ("train.Trainer.compute_cache", "train.Trainer.train_epoch",
               "train.Trainer.evaluate", "train.Trainer.fit",
               "train.Trainer.save_checkpoint")),
    "example_state": ("orbax's restore target: the port's Trainer restores "
                      "into itself", ("train.Trainer.load_checkpoint",)),
    "param_dtype": ("Flax's parameter dtype: a torch module is cast with "
                    ".to(dtype)", ("models.GatingContext", "models.NetVLAD")),
    "pack_width": ("PackedPairConv, a TPU lane tiling of VGG's first block; "
                   "the port runs the plain convs on the same weights",
                   ("models.VGG16Encoder",
                    "models.encoders.build_image_encoder")),
    "axis": ("a mesh axis name: the port's sharded calls take a process "
             "group", ("parallel.ShardedBank", "parallel.sharded_topk")),
    "donate": ("XLA buffer donation; torch has no counterpart",
               ("parallel.spatial_sharded_apply",)),
    "platforms": ("jax.export's target platforms: a torch.export program "
                  "runs where it is loaded", ("export.export_fn",)),
}
WHOLE_MODULES = ("models.encoders", "export", "config")
PORT_NAMES = {"__call__": "forward", "setup": "__init__"}
_MACHINERY = {"__init__", "__new__", "__post_init__", "__eq__", "__hash__",
              "__repr__", "__setattr__", "__delattr__", "__getnewargs__"}


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


def _walked():
    """(label, JAX object, the port's object or None) for every walked
    class and function."""
    out = []

    def add(label, module, port_module, name):
        out.append((label, getattr(module, name),
                    getattr(port_module, name, None)))

    for package in SUBPACKAGES:
        jax_pkg = importlib.import_module(f"gloc3d_tpu.{package}")
        port_pkg = importlib.import_module(f"gloc3d_tpu_torch.{package}")
        for name in jax_exports(package):
            value = getattr(jax_pkg, name)
            if isinstance(value, types.ModuleType):  # models.losses
                port_mod = getattr(port_pkg, name)
                for fn in _module_functions(value):
                    add(f"{package}.{name}.{fn}", value, port_mod, fn)
            add(f"{package}.{name}", jax_pkg, port_pkg, name)
    for name in ("GlobalLocalizer", "LocalizationResult"):
        add(f"pipeline.{name}", importlib.import_module("gloc3d_tpu.pipeline"),
            importlib.import_module("gloc3d_tpu_torch.pipeline"), name)
    for mod in WHOLE_MODULES:
        jax_mod = importlib.import_module(f"gloc3d_tpu.{mod}")
        port_mod = importlib.import_module(f"gloc3d_tpu_torch.{mod}")
        for name, value in vars(jax_mod).items():
            if (not name.startswith("_") and inspect.isclass(value)
                    and value.__module__ == jax_mod.__name__):
                add(f"{mod}.{name}", jax_mod, port_mod, name)
        for name in _module_functions(jax_mod):
            add(f"{mod}.{name}", jax_mod, port_mod, name)
    return out


def _module_functions(module):
    """The public functions ``module`` defines, jitted ones included."""
    return [n for n, v in vars(module).items() if not n.startswith("_")
            and callable(v) and not inspect.isclass(v)
            and getattr(v, "__module__", None) == module.__name__]


def _params(obj):
    """The names a function, method or constructor takes."""
    sig = inspect.signature(obj)
    return {n for n, p in sig.parameters.items()
            if n not in ("self", "cls", "parent", "name")
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def _fields(cls):
    if dataclasses.is_dataclass(cls):
        return {f.name for f in dataclasses.fields(cls)} - {"parent", "name"}
    return set(getattr(cls, "_fields", ()))


def _methods(cls):
    """{name: the function} of the public methods, static and class methods,
    properties and operators that the package's own classes define."""
    out = {}
    for base in cls.__mro__:
        if not base.__module__.startswith("gloc3d_tpu"):
            continue  # flax.linen.Module, tuple, object
        for name, value in vars(base).items():
            dunder = name.startswith("__") and name.endswith("__")
            if (name in out or name in _MACHINERY
                    or (name.startswith("_") and not dunder)):
                continue
            if isinstance(value, (staticmethod, classmethod)):
                out[name] = value.__func__
            elif inspect.isfunction(value) or isinstance(value, property):
                out[name] = value
    return out


def _kind(obj):
    return ("module" if isinstance(obj, types.ModuleType) else
            "class" if inspect.isclass(obj) else
            "function" if callable(obj) else type(obj).__name__)


def _gaps(label, jax_obj, port_obj):
    """What ``port_obj`` lacks of ``jax_obj``: {("missing", label)},
    ("kind", label), ("method", owner), ("param", owner, name)}."""
    if port_obj is None:
        return {("missing", label)}
    if _kind(port_obj) != _kind(jax_obj):
        return {("kind", label)}
    if isinstance(jax_obj, types.ModuleType):  # its functions are walked
        return set()
    if not inspect.isclass(jax_obj):  # a function, jitted or not
        return {("param", label, p) for p in _params(jax_obj)
                - _params(port_obj)}
    port_ctor = _params(port_obj) | _fields(port_obj)
    gaps = {("param", label, p) for p in (_params(jax_obj) | _fields(jax_obj))
            - port_ctor}
    for name, fn in _methods(jax_obj).items():
        owner = f"{label}.{name}"
        port_fn = inspect.getattr_static(port_obj, PORT_NAMES.get(name, name),
                                         None)
        if port_fn is None:
            gaps.add(("method", owner))
        elif not isinstance(fn, property):
            if isinstance(port_fn, (staticmethod, classmethod)):
                port_fn = port_fn.__func__
            gaps |= {("param", owner, p) for p in _params(fn)
                     - _params(port_fn)}
    return gaps


WALKED = _walked()
LABELS = {w[0] for w in WALKED}


def _owner(entry):
    """The walked label a table entry belongs to: itself, or the class
    whose method it names."""
    return entry if entry in LABELS else entry.rpartition(".")[0]


def _listed(label):
    """The gaps the tables list for ``label`` and its methods."""
    pkg, _, name = label.rpartition(".")
    out = {("missing", label)} if (pkg, name) in LEFT_OUT else set()
    out |= {("method", m) for m in METHODS_LEFT_OUT if _owner(m) == label}
    for p, (_, owners) in PARAMS_LEFT_OUT.items():
        out |= {("param", o, p) for o in owners if _owner(o) == label}
    return out


@pytest.mark.parametrize("label,jax_obj,port_obj", WALKED,
                         ids=[w[0] for w in WALKED])
def test_public_surface_matches_jax(label, jax_obj, port_obj):
    gaps, listed = _gaps(label, jax_obj, port_obj), _listed(label)
    assert not gaps - listed, f"unlisted gaps: {sorted(gaps - listed)}"
    assert not listed - gaps, ("table entries that no longer hold: "
                               f"{sorted(listed - gaps)}")


def test_every_table_entry_names_a_walked_object():
    entries = [f"{p}.{n}" for p, n in LEFT_OUT] + list(METHODS_LEFT_OUT)
    entries += [o for _, owners in PARAMS_LEFT_OUT.values() for o in owners]
    assert all(_owner(e) in LABELS for e in entries), [
        e for e in entries if _owner(e) not in LABELS]
    reasons = [why for why, _ in PARAMS_LEFT_OUT.values()]
    reasons += list(METHODS_LEFT_OUT.values()) + list(LEFT_OUT.values())
    assert all(reasons)


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
