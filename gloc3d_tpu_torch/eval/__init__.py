from gloc3d_tpu_torch.eval.recall import (  # noqa: F401
    ground_truth_positives, recall_at_n,
)
from gloc3d_tpu_torch.eval.registration import (  # noqa: F401
    compose_6dof,
    registration_errors,
    registration_stats,
)
