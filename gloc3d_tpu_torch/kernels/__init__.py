"""The hand-written kernels. Importing the package registers each as a
``gloc3d::`` custom op (``ops.py``)."""

from gloc3d_tpu_torch.kernels import ops  # noqa: F401
