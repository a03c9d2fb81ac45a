"""The port's BEV image loading (``gloc3d_tpu_torch/data/images.py``)
against the JAX package's: equal arrays, origins and paths, exactly."""

import sys
import types

import numpy as np
import pytest

from gloc3d_tpu.data import images as jax_images
from gloc3d_tpu_torch.data import images
from test_torch_threads import _two_threads  # noqa: F401


def _bev(h, w, seed):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(h, w) < 0.1, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w,size", [(4, 6, 8), (10, 10, 4), (7, 12, 9),
                                      (64, 64, 64)])
def test_pad_and_crop_matches_jax(h, w, size):
    img = _bev(h, w, h * w)
    np.testing.assert_array_equal(images.pad_and_crop(img, size),
                                  jax_images.pad_and_crop(img, size))


@pytest.fixture
def image_dir(tmp_path):
    """npz files with and without ``resolution``, larger and smaller than
    the loaded size, and one JPEG."""
    from PIL import Image

    np.savez(str(tmp_path / "000000.npz"), image=_bev(100, 120, 0),
             origin_xy=np.array([3.0, -1.0]), resolution=0.5)
    np.savez(str(tmp_path / "000001.npz"), image=_bev(40, 30, 1),
             origin_xy=np.array([-2.5, 4.0]))
    np.savez(str(tmp_path / "000002.npz"), image=_bev(70, 50, 2),
             origin_xy=np.array([0.0, 0.0]), resolution=0.2)
    Image.fromarray(_bev(90, 60, 3)).save(str(tmp_path / "000003.jpg"),
                                          quality=95)
    return tmp_path


@pytest.mark.parametrize("size", [64, 128])
def test_load_bev_images_matches_jax(image_dir, size):
    paths = [str(image_dir / f) for f in ("000000.npz", "000001.npz",
                                          "000002.npz", "000003.jpg")]
    got = images.load_bev_images(paths, size)
    want = jax_images.load_bev_images(paths, size)
    assert got[0].shape == (4, size, size, 3) and got[0].dtype == np.float32
    assert got[1].shape == (4, 2) and got[1].dtype == np.float32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_image_paths_for_scans_matches_jax(image_dir):
    scans = [f"/data/velodyne/{i:06d}.bin" for i in range(5)]
    got = images.image_paths_for_scans(scans, str(image_dir))
    assert got == jax_images.image_paths_for_scans(scans, str(image_dir))
    assert got[3].endswith("000003.jpg") and got[4].endswith("000004.npz")


def test_load_split_images_matches_jax(image_dir):
    split = types.SimpleNamespace(
        db_files=["a/000000.bin", "a/000001.bin"],
        q_files=["b/000002.bin", "b/000003.bin"],
        utm_db=np.array([[0.0, 0.0], [10.0, 0.0]]),
        utm_q=np.array([[1.0, 0.0], [9.0, 1.0]]),
        db_poses=np.stack([np.eye(4)] * 2), q_poses=np.stack([np.eye(4)] * 2))
    got = images.load_split_images(split, str(image_dir), size=64)
    want = jax_images.load_split_images(split, str(image_dir), size=64)
    for name in ("db_inputs", "q_inputs", "utm_db", "utm_q", "db_poses",
                 "q_poses", "db_origins", "q_origins"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.db_masks is None and got.num_q == 2


def test_jpeg_without_pil_raises_import_error(image_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        images.load_bev_images([str(image_dir / "000003.jpg")], 64)
    # .npz files need no PIL
    imgs, _ = images.load_bev_images([str(image_dir / "000001.npz")], 64)
    assert imgs.shape == (1, 64, 64, 3)
