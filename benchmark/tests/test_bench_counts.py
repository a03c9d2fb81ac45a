"""The yardstick's operation and byte counts against the figures PERF.md
gives for them."""

import json
import os

import pytest

from lbench import flops

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)["pipeline"]


def test_vgg16_flops_at_768():
    assert round(flops.vgg16_flops(768) / 1e9, 1) == 360.8


@pytest.mark.parametrize("shape, bound_ms", [
    ((1, 122480, 4), 0.0008), ((1, 122480, 64), 0.0104),
    ((24, 122480, 4), 0.0192), ((24, 122480, 64), 0.2490)])
def test_k2_bounds(shape, bound_ms):
    b, n, c = shape
    ms = flops.k2_bytes(b, n, c, 140 * 80) / flops.HBM_BYTES_PER_S * 1e3
    assert round(ms, 4) == bound_ms


def test_descriptor_flops_of_the_configurations():
    s2s = flops.descriptor_flops(_cfg("s2s-pointpillar-netvladfc"))
    i2i = flops.descriptor_flops(_cfg("i2i-vgg16-netvladfc"))
    # PointPillar 140 x 80 with its heads; NetVLAD-FC 64 x 128 over 11 200
    assert 52e9 < s2s < 55e9
    # VGG16 at 768² and NetVLAD-FC 64 x 512 over 48²
    assert i2i == flops.vgg16_flops(768) + 2 * 2304 * 512 * 64 * 2 \
        + 2 * 64 * 512 * 512
    assert flops.k2_bytes_per_scan(_cfg("s2s-pointpillar-netvladfc")[
        "voxel"]) == flops.k2_bytes(1, 122480, 4, 11200) + flops.k2_bytes(
            1, 122480, 64, 11200)
