"""gloc3d_tpu_torch: the PyTorch / CUDA port of gloc3d_tpu for NVIDIA Hopper.

The s2s located query (scan → PointPillar + NetVLAD descriptor → exact
top-k → FFT BEV registration → 6-DoF pose), on the host-stats serving path
and on the all-device path, plain or gravity-aligned (ground RANSAC on the
device), and s2s triplet training; ``eval/evaluator.py::evaluate_split``
evaluates a localizer over a split read from disk (``data/kitti.py``,
``nclt.py``, ``nuscenes.py``). ``cli.py`` is the command line
(``python -m gloc3d_tpu_torch.cli``), ``export.py`` the serialized-model
hand-off and ``profiling.py`` the registry of spans and counters that
``locate_fused`` and ``locate_batch`` record while a ``torch.profiler``
profile records, or within ``profiling.record()`` (host spans on the
profiler's clock, device spans timed by CUDA events, inside the captured
graphs too), and the profiler trace.
``parallel/`` runs the JAX package's mesh paths over the ranks of a
``torch.distributed`` process group: the sharded search, the sharded
keyframe store and matcher, data parallelism and the i2i spatial
partition. The JAX package ``gloc3d_tpu`` is the reference; this package
imports no JAX and loads no file of the JAX package: it keeps its own
copies of the config, the dataset container, recall, the data readers and
the native host pass and file loaders. Entry points run on the card unless
the caller passes ``device="cpu"``. Both TPU kernels of the JAX package are
hand-written CUDA kernels here, reached only through the custom ops of
``kernels/ops.py``: ``_cumsum_rows_128`` as ``csrc/segment_sum.cu``
(``kernels/segment_sum.py``, the sorted feature mean of the host-stats
path) and ``pillar_bin_sums`` as ``csrc/pillar_bin_sums.cu``
(``kernels/bin_sums.py``, both binnings of the all-device path).

The names below load on first use (PEP 562), so that importing a
submodule such as ``gloc3d_tpu_torch.kernels.ops`` does not import the
models or the pipeline.
"""

from gloc3d_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "BEVConfig": "config", "GroundConfig": "config", "IndexConfig": "config",
    "MatchConfig": "config", "MeshConfig": "config", "ModelConfig": "config",
    "PipelineConfig": "config", "TrainConfig": "config",
    "VoxelConfig": "config",
    "build_model": "models.descriptor", "init_params": "models.descriptor",
    "GlobalLocalizer": "pipeline", "LocalizationResult": "pipeline",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
