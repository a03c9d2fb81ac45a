"""The hand-written kernels. Importing the package registers both as
``gloc3d::`` custom ops (``ops.py``)."""

from gloc3d_tpu_torch.kernels import ops  # noqa: F401
