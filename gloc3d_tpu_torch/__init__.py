"""gloc3d_tpu_torch: the PyTorch / CUDA port of gloc3d_tpu for NVIDIA Hopper.

The s2s located query (scan → PointPillar + NetVLAD descriptor → exact
top-k → FFT BEV registration → 6-DoF pose), on the host-stats serving path
and on the all-device path, plain or gravity-aligned (ground RANSAC on the
device), and s2s triplet training; ``eval/evaluator.py::evaluate_split``
evaluates a localizer over a split read from disk (``data/kitti.py``,
``nclt.py``, ``nuscenes.py``). The JAX package ``gloc3d_tpu`` is the
reference; this package imports no JAX and loads no file of the JAX
package: it keeps its own copies of the config, the dataset container,
recall, the data readers and the native host pass and file loaders. Entry points run on the card unless the
caller passes ``device="cpu"``. Both TPU kernels of the JAX package are
hand-written CUDA kernels here: ``_cumsum_rows_128`` as
``csrc/segment_sum.cu`` (``kernels/segment_sum.py``, the sorted feature
mean of the host-stats path) and ``pillar_bin_sums`` as
``csrc/pillar_bin_sums.cu`` (``kernels/bin_sums.py``, both binnings of the
all-device path).
"""

from gloc3d_tpu_torch.config import (
    BEVConfig, GroundConfig, IndexConfig, MatchConfig, MeshConfig,
    ModelConfig, PipelineConfig, TrainConfig, VoxelConfig,
)
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from gloc3d_tpu_torch.pipeline import GlobalLocalizer, LocalizationResult

__all__ = [
    "BEVConfig", "GlobalLocalizer", "GroundConfig", "IndexConfig",
    "LocalizationResult", "MatchConfig", "MeshConfig", "ModelConfig",
    "PipelineConfig", "TrainConfig", "VoxelConfig", "build_model",
    "init_params",
]
