"""Training: triplet mining, cluster init and the triplet trainer (s2s
and i2i, with the reference's freeze masks), and the pose trainer (port of
``gloc3d_tpu/train``)."""

from gloc3d_tpu_torch.train.cluster import init_vlad_from_data  # noqa: F401
from gloc3d_tpu_torch.train.mining import mine_triplets  # noqa: F401
from gloc3d_tpu_torch.train.pose import (  # noqa: F401
    init_pose_state, make_pose_model, pose_train_step, predict_pose,
)
from gloc3d_tpu_torch.train.trainer import Trainer  # noqa: F401
