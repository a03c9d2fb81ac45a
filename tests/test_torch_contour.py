"""ops/contour.py: the port against the JAX functions on the cases of
tests/test_contour.py. Everything here is integer arithmetic after the
threshold, so labels, areas, erosions and the virtual cloud (with JAX's own
permutation injected) are held equal, not to a tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from gloc3d_tpu.ops import contour as jc
from gloc3d_tpu_torch.ops import contour as tc
from test_contour import EIGHT, _random_blobs
from test_torch_threads import _two_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_perm(s):
    return torch.from_numpy(np.asarray(
        jax.random.permutation(jax.random.PRNGKey(0), s * s)).astype(
            np.int64))


def _snake(s=64):
    occ = np.zeros((s, s), np.float32)
    for r in range(0, s, 4):
        occ[r, :] = 1.0
        if (r // 4) % 2 == 0:
            occ[r:r + 5, s - 1] = 1.0
        else:
            occ[r:r + 5, 0] = 1.0
    return occ


@pytest.mark.parametrize("scene", ["blobs", "snake"])
def test_connected_components_match_jax(scene):
    occ = _random_blobs() if scene == "blobs" else _snake()
    got = tc.connected_components(_t(occ)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jc.connected_components(jnp.asarray(occ))))
    assert got.dtype == np.int32
    ref, n = ndi.label(occ, structure=EIGHT)
    assert (got[occ < 0.5] == occ.size).all()
    assert len({got[ref == i][0] for i in range(1, n + 1)}) == n
    for i in range(1, n + 1):
        assert len(np.unique(got[ref == i])) == 1


@pytest.mark.parametrize("num_sweeps", [1, 2, 5])
def test_sweep_cap_matches_jax(num_sweeps):
    """A capped run stops where JAX's does, short of convergence on the
    snake: the port's grouped reads of the "changed" flag never run past
    the cap."""
    occ = _snake()
    np.testing.assert_array_equal(
        tc.connected_components(_t(occ), num_sweeps).numpy(),
        np.asarray(jc.connected_components(jnp.asarray(occ), num_sweeps)))


def test_erode_matches_jax_and_scipy():
    occ = _random_blobs(seed=1)
    got = tc.erode3x3(_t(occ)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.erode3x3(
        jnp.asarray(occ))))
    np.testing.assert_array_equal(got, ndi.binary_erosion(
        occ > 0.5, structure=EIGHT).astype(np.float32))


def test_component_areas_match_jax():
    occ = np.zeros((16, 16), np.float32)
    occ[2:6, 2:6] = 1.0
    occ[10:12, 10:13] = 1.0
    labels = tc.connected_components(_t(occ))
    areas = tc.component_areas(labels).numpy()
    np.testing.assert_array_equal(areas, np.asarray(jc.component_areas(
        jnp.asarray(labels.numpy()))))
    assert sorted(areas[np.unique(labels.numpy()[occ > 0.5])]) == [6, 16]


@pytest.mark.parametrize("scene", ["area_filter", "one_blob"])
def test_contour_virtual_cloud_matches_jax(scene):
    """tests/test_contour.py's area filter (a kept 32² blob, an eroded
    speck, a dropped giant region) and its 64² single blob."""
    if scene == "area_filter":
        s, budget, min_area = 128, 4096, 100
        img = np.ones((s, s), np.float32)
        img[8:40, 8:40] = 0.0
        img[60:63, 60:63] = 0.0
        img[:, 90:] = 0.0
        origin = np.array([-12.8, -12.8], np.float32)
    else:
        s, budget, min_area = 64, 512, 50
        img = np.ones((s, s), np.float32)
        img[10:30, 10:30] = 0.0
        origin = np.zeros(2, np.float32)
    want = jc.contour_virtual_cloud(jnp.asarray(img), jnp.asarray(origin),
                                    0.2, budget=budget, min_area=min_area)
    got = tc.contour_virtual_cloud(_t(img), _t(origin), 0.2, budget=budget,
                                   min_area=min_area, perm=_jax_perm(s))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    kept = got[0].numpy()[got[1].numpy() > 0.5]
    if scene == "area_filter":  # only the eroded 30² blob survives
        cols = (kept[:, 0] - origin[0]) / 0.2
        rows = (kept[:, 1] - origin[1]) / 0.2
        assert (cols >= 8).all() and (cols < 40).all()
        assert (rows >= 8).all() and (rows < 40).all()
        assert abs(len(kept) - 30 * 30) <= 60
    else:
        assert got[0].shape == (512, 2) and 200 < len(kept) < 400
