"""Relative-pose regression training.

Port of ``gloc3d_tpu/train/pose.py``: a scan-pair model (one shared
PointPillar in mode ``"pose"`` → ``PoseHead`` → 6-DoF [angle-axis |
translation]) and a minimal pair trainer around ``losses.pose_loss``.

The encoder runs on the query scans, then on the reference scans; in train
mode each call moves its BatchNorm running statistics, twice per step in
that order, as the Flax module's two calls do. The optimizer is
``torch.optim.Adam(lr)``, which is ``optax.adam(lr)`` (eps 1e-8 outside
the square root). The binning runs on the device: kernel K2 for the pillar
statistics and for the feature mean of both scans, forward and backward.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.models.losses import pose_loss
from gloc3d_tpu_torch.models.packed import PoseHead
from gloc3d_tpu_torch.models.pointpillar import PointPillar


class PosePairModel(nn.Module):
    """(scan_q, mask_q, scan_p, mask_p) → (B, 6) relative pose
    [angle-axis | translation] of T_p←q."""

    def __init__(self, xbound: Sequence[float], ybound: Sequence[float],
                 zbound: Sequence[float],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = PointPillar(xbound, ybound, zbound, compute_dtype,
                                   mode="pose")
        self.pose_head = PoseHead()

    def forward(self, pts_q, mk_q, pts_p, mk_p) -> torch.Tensor:
        enc_q = self.encoder(pts_q, mk_q, mode="pose")
        enc_p = self.encoder(pts_p, mk_p, mode="pose")
        return self.pose_head(enc_q, enc_p)


class PoseTrainState(NamedTuple):
    model: PosePairModel
    optimizer: torch.optim.Optimizer


def make_pose_model(cfg) -> PosePairModel:
    v = cfg.voxel
    return PosePairModel(v.xbound, v.ybound, v.zbound,
                         getattr(torch, cfg.model.compute_dtype))


@torch.no_grad()
def init_pose_params(model: PosePairModel,
                     generator: Optional[torch.Generator] = None
                     ) -> PosePairModel:
    """Seeded init at the scale of Flax's initializers, drawn from
    ``generator``: every conv and Linear weight normal with std
    1/sqrt(fan_in) (Flax: lecun-normal), biases 0, BatchNorm at identity.
    Not JAX's numbers: parity tests load JAX's init through
    ``convert.pose_state_dict``."""
    gen = generator if generator is not None else torch.Generator(
    ).manual_seed(0)
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return model


def init_pose_state(model: PosePairModel, lr: float = 1e-3,
                    generator: Optional[torch.Generator] = None,
                    init: bool = True, *, device=None) -> PoseTrainState:
    """The model on ``device`` (the card unless ``"cpu"`` is given) with
    its Adam optimizer; ``init=False`` keeps the weights it holds (e.g.
    loaded from a converted Flax tree)."""
    dev = resolve_device(device, "init_pose_state")
    if init:
        init_pose_params(model, generator)
    model = model.to(dev)
    return PoseTrainState(model, torch.optim.Adam(model.parameters(), lr=lr))


def _on(model: nn.Module, tensors):
    dev = next(model.parameters()).device
    return [torch.as_tensor(t, dtype=torch.float32).to(dev) for t in tensors]


def pose_train_step(state: PoseTrainState, batch, gt,
                    angle_scale: float = 1.0) -> torch.Tensor:
    """One Adam step on a pair batch ``(pts_q, mk_q, pts_p, mk_p)`` with
    ``gt`` (B, 6) the angle-axis | translation of T_p←q, on the model's
    device. Returns the loss (a device scalar)."""
    model, opt = state
    *batch, gt = _on(model, (*batch, gt))
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = pose_loss(model(*batch), gt, angle_scale)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def predict_pose(state: PoseTrainState, batch) -> torch.Tensor:
    """Eval-mode (B, 6) relative poses of a pair batch."""
    model = state.model
    model.eval()
    return model(*_on(model, batch))
