"""s2s triplet training: mining, cluster init and the trainer (port of
``gloc3d_tpu/train``; the pose trainer comes with ROADMAP item 15)."""

from gloc3d_tpu_torch.train.cluster import init_vlad_from_data  # noqa: F401
from gloc3d_tpu_torch.train.mining import mine_triplets  # noqa: F401
from gloc3d_tpu_torch.train.trainer import Trainer  # noqa: F401
