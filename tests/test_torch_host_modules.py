"""The port's own host modules against the JAX package's: the config
(presets, JSON), the native host pass (bit-equal outputs), its loader
(raises, never falls back to numpy), and the entry points' default device
(the card, or an error that names ``device="cpu"``)."""

import json

import numpy as np
import pytest
import torch

from gloc3d_tpu import config as jax_config
from gloc3d_tpu.data import native as jax_native
from gloc3d_tpu.data.dataset import TripletDataset as JaxDataset
from gloc3d_tpu.eval.recall import recall_at_n as jax_recall
from gloc3d_tpu_torch import config
from gloc3d_tpu_torch.data import native
from gloc3d_tpu_torch.data.dataset import TripletDataset
from gloc3d_tpu_torch.eval.recall import recall_at_n
from gloc3d_tpu_torch.index.bank import DescriptorBank
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.pipeline import GlobalLocalizer
from gloc3d_tpu_torch.train import Trainer
from test_torch_threads import _two_threads  # noqa: F401


PRESETS = {
    "default": lambda c: c.PipelineConfig(),
    "s2s": lambda c: c.PipelineConfig.s2s(),
    "fast_match": lambda c: c.PipelineConfig.s2s().fast_match(),
    "fast_match_fm": lambda c: c.PipelineConfig.s2s().fast_match(fm=True),
    **{f"i2i_{e}": (lambda e: lambda c: c.PipelineConfig.i2i(e))(e)
       for e in ("vgg16", "alexnet", "mobilenet", "resnet18")},
}
SECTIONS = ("BEVConfig", "VoxelConfig", "ModelConfig", "IndexConfig",
            "GroundConfig", "MatchConfig", "MeshConfig", "TrainConfig")


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_config_presets_match_jax(preset):
    ours, ref = PRESETS[preset](config), PRESETS[preset](jax_config)
    assert ours.to_dict() == json.loads(ref.to_json())
    assert ours.to_json() == ref.to_json()


@pytest.mark.parametrize("section", SECTIONS)
def test_config_sections_match_jax(section):
    ours, ref = getattr(config, section)(), getattr(jax_config, section)()
    assert ours.to_dict() == json.loads(ref.to_json())


def test_jax_json_loads_in_the_port_and_round_trips():
    ref = jax_config.PipelineConfig.s2s().fast_match(fm=True).replace(
        voxel=jax_config.VoxelConfig(xbound=(-10.0, 10.0, 0.25),
                                     max_points=4096))
    ours = config.PipelineConfig.from_json(ref.to_json())
    assert isinstance(ours.voxel, config.VoxelConfig)
    assert ours.voxel.xbound == (-10.0, 10.0, 0.25)
    assert ours.voxel.grid_size == (80, 80, 1)
    assert ours.match.coarse_mode == "fm"
    assert ours.to_json() == ref.to_json()
    back = jax_config.PipelineConfig.from_json(ours.to_json())
    assert back == ref
    assert config.PipelineConfig.from_json(ours.to_json()) == ours


def test_dataset_and_recall_match_jax():
    rng = np.random.RandomState(0)
    utm_db, utm_q = rng.uniform(-50, 50, (30, 2)), rng.uniform(-50, 50, (7, 2))
    args = (np.zeros((30, 1)), np.zeros((7, 1)), utm_db, utm_q)
    ours, ref = TripletDataset(*args), JaxDataset(*args)
    for name, r in (("nontrivial_positives", 10.0),
                    ("potential_negatives", 20.0), ("eval_positives", 20.0)):
        np.testing.assert_array_equal(getattr(ours, name)(r),
                                      getattr(ref, name)(r))
    pred = np.argsort(rng.rand(7, 30), axis=1)[:, :20]
    pos = ours.eval_positives(25.0)
    assert recall_at_n(pred, pos) == jax_recall(pred, pos)


def _scans(seed, b=3, n=3000):
    """Padded scans with out-of-grid rows, rows just below the grid minimum
    (trunc-to-zero aliasing) and different real counts."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    counts = np.array([n - 500 * i for i in range(b)], np.int64)
    for i, c in enumerate(counts):
        pts[i, :c, 0] = rng.uniform(-45, 45, c)
        pts[i, :c, 1] = rng.uniform(-25, 25, c)
        pts[i, :c, 2] = rng.uniform(-3, 4, c)
        pts[i, :c, 3] = rng.uniform(0, 1, c)
        pts[i, :20, 0] = -35.0 - rng.uniform(0, 0.49, 20)
    return pts, counts


@pytest.mark.parametrize("crop,per_point,max_points", [
    (False, False, None), (False, True, None), (True, True, None),
    (True, False, 2000)])
def test_voxel_stats_sorted_bit_equal_to_jax(crop, per_point, max_points):
    pts, counts = _scans(1)
    bounds = ((-35.0, 35.0, 0.5), (-20.0, 20.0, 0.5), (-10.0, 10.0, 20.0))
    ours = native.compute_voxel_stats_host_sorted(
        pts, counts, *bounds, crop=crop, max_points=max_points,
        per_point=per_point)
    # one scan per JAX call: JAX's library reads scan i at row i * M of the
    # input, so with a budget M below the pad it reads scans 1 and 2 from
    # the wrong rows (the port's passes the input's own row count)
    ref = tuple(np.concatenate(parts) for parts in zip(*(
        jax_native.compute_voxel_stats_host_sorted(
            pts[i:i + 1], counts[i:i + 1], *bounds, crop=crop,
            max_points=max_points, per_point=per_point)
        for i in range(len(pts)))))
    assert len(ours) == len(ref) == (7 if per_point else 6)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("image_size,cols", [(128, 4), (256, 3)])
def test_bev_host_bit_equal_to_jax(image_size, cols):
    pts, counts = _scans(2)
    bev = config.BEVConfig(image_size=image_size)
    ours = native.compute_bev_host(pts[..., :cols], counts, bev)
    ref = jax_native.compute_bev_host(pts[..., :cols], counts,
                                      jax_config.BEVConfig(
                                          image_size=image_size))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert (ours[2] > 0).all()


def test_loader_build_failure_raises_and_nothing_falls_back(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot build"):
        native.load_library()
    pts, counts = _scans(3, b=1, n=100)
    with pytest.raises(RuntimeError, match="cannot build"):
        native.compute_voxel_stats_host_sorted(
            pts, counts, (-35.0, 35.0, 0.5), (-20.0, 20.0, 0.5),
            (-10.0, 10.0, 20.0))
    with pytest.raises(RuntimeError, match="cannot build"):
        native.compute_bev_host(pts, counts, config.BEVConfig())
    assert not list(tmp_path.glob("*.so"))


def test_loader_compile_error_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed on"):
        native.load_library()


def test_loader_builds_into_the_port_build_dir():
    lib = native.load_library()
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR)
    assert lib._name == path


_SMALL = config.PipelineConfig(
    voxel=config.VoxelConfig(max_points=256, xbound=(-4.0, 4.0, 0.5),
                             ybound=(-4.0, 4.0, 0.5)),
    model=config.ModelConfig(compute_dtype="float32", fold_bn=False))


def _entry_points(tmp_path):
    model = build_model(_SMALL.model, _SMALL.voxel)
    ds = TripletDataset(np.zeros((2, 256, 4), np.float32),
                        np.zeros((1, 256, 4), np.float32),
                        np.zeros((2, 2)), np.zeros((1, 2)),
                        np.ones((2, 256), np.float32),
                        np.ones((1, 256), np.float32))
    return {
        "GlobalLocalizer": lambda **kw: GlobalLocalizer(_SMALL, model, **kw),
        "DescriptorBank": lambda **kw: DescriptorBank(_SMALL.index, **kw),
        "Trainer": lambda **kw: Trainer(_SMALL, model, ds,
                                        str(tmp_path / "run"), **kw),
    }


@pytest.mark.parametrize("entry", ["GlobalLocalizer", "DescriptorBank",
                                   "Trainer"])
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    make = _entry_points(tmp_path)[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    assert make(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from gloc3d_tpu_torch.core.device import resolve_device
    assert resolve_device(None, entry) == torch.device("cuda")
