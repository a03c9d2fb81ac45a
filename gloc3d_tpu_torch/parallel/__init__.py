"""The port's multi-rank paths over ``torch.distributed`` (a JAX mesh is a
process group here): the collectives they share (``collectives.py``), the
sharded search (``sharding.py``), data parallelism's helpers (``data.py``:
``Trainer(mesh=...)`` and ``GlobalLocalizer.shard_extraction`` use them),
one command's ranks (``launch.py::spawn``) and the multi-rank dry run
(``dryrun.py::dryrun_multichip``). ``make_mesh``, ``shard_batch``,
``replicate`` and ``spatial_sharded_apply`` are not ported (ROADMAP Queue
1, item 16c)."""

from gloc3d_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardedBank,
    merge_topk,
    sharded_topk,
    sharded_topk_int8,
)
