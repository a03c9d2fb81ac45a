"""CPU tests of the benchmark harness: the harness's own parts at a tiny
size, with the port running its plain kernels on the CPU. Run from the
repository root: ``python -m pytest benchmark/tests -q``. The ``cuda``
cases skip themselves without a card; on the card they run with
``-m cuda``."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

# a cell cut to run in seconds on the CPU: a 20 x 12 m pillar grid, 8 192
# points a scan, 256² BEV images, a 512-candidate, 64-hypothesis RANSAC,
# a 40-row map with 4 real keyframes, and one or two calls to trace; the
# networks in float32, so that the port and the reference agree to
# rounding and the cells' own limits hold them
TINY = {
    "pipeline": {"model": {"compute_dtype": "float32"},
                 "voxel": {"max_points": 8192, "xbound": [-10.0, 10.0, 0.5],
                           "ybound": [-6.0, 6.0, 0.5]},
                 "bev": {"image_size": 256},
                 "ground": {"num_candidates": 512, "ransac_iters": 64}},
    "traffic": {"world": {"n_walls": 60, "extent_m": 40.0, "view_m": 30.0,
                          "n_ground": 2000},
                "map": {"keyframes": 40, "grid": 2, "build_batch": 2,
                        "cluster_scans": 2},
                "pool": {"off_map": 2, "off_map_every": 4},
                "warmup_units": 3, "trace_units": 2, "sync_units": 1,
                "check": {"on_map": 2, "off_map": 1, "batches": 1}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips itself without one")


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.cuda.get_device_name(0)
