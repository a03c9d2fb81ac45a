"""The port's multi-rank paths over ``torch.distributed`` (a JAX mesh is a
process group here): the sharded search. ``make_mesh``, ``shard_batch``,
``replicate`` and ``spatial_sharded_apply`` are not ported (ROADMAP Queue
1, items 16b-16c)."""

from gloc3d_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardedBank,
    merge_topk,
    sharded_topk,
    sharded_topk_int8,
)
