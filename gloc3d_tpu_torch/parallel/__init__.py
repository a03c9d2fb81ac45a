"""The port's multi-rank paths over ``torch.distributed`` (a JAX mesh is a
process group here): the collectives they share (``collectives.py``), the
mesh (``mesh.py::make_mesh``), the sharded search (``sharding.py``), data
parallelism's helpers (``data.py``: ``Trainer(mesh=...)`` and
``GlobalLocalizer.shard_extraction`` use them), the i2i spatial partition
(``spatial.py``), one command's ranks (``launch.py::spawn``) and the
multi-rank dry run (``dryrun.py::dryrun_multichip``). ``shard_batch`` and
``replicate`` place JAX arrays on a mesh; each rank of a process group
holds its own tensors, so they have no counterpart. The names load on
first use."""

from gloc3d_tpu_torch._lazy import lazy_exports

_EXPORTS = {"make_mesh": "mesh", "ShardedBank": "sharding",
            "merge_topk": "sharding", "sharded_topk": "sharding",
            "sharded_topk_int8": "sharding",
            "spatial_sharded_apply": "spatial",
            "check_divisible": "spatial"}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
