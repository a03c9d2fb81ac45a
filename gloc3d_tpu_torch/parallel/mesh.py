"""The mesh: a process group over the default group's ranks.

Port of ``gloc3d_tpu/parallel/mesh.py::make_mesh``. A JAX ``Mesh`` of N
devices is, in the port, a ``torch.distributed`` process group of N ranks
(``parallel/sharding.py``), and ``None`` names the default group. Every
rank calls ``make_mesh`` with the same arguments, as
``torch.distributed.new_group`` requires; a rank outside the new group gets
``GroupMember.NON_GROUP_MEMBER`` and takes no part in its calls.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist

from gloc3d_tpu_torch.config import MeshConfig


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence[int]] = None):
    """The process group of the first ``cfg.num_devices`` ranks of the
    default group (0: all of them), or of the ranks ``devices`` (default
    group ranks, in place of JAX's device list). Returns None, the default
    group, when that is every rank in order."""
    cfg = cfg or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    ranks = list(range(world))
    if devices is not None:
        ranks = [int(r) for r in devices]
    elif cfg.num_devices:
        ranks = ranks[: cfg.num_devices]
    if ranks == list(range(world)):
        return None
    return dist.new_group(ranks)
