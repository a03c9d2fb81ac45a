"""VGG16 convolutional encoder in PyTorch (i2i path).

Port of ``gloc3d_tpu/models/vgg.py::VGG16Encoder``: the 13 convs of
torchvision ``vgg16.features[:-2]`` (conv1_1 … conv5_3, no ReLU after the
last conv and no final max-pool, main.py:531-541), which maps a 768×768 BEV
image to a (48, 48, 512) feature map. 3×3 convs with padding 1 (Flax
``SAME`` at stride 1) and 2×2/2 max-pools (Flax ``VALID``) before convs 2,
4, 7 and 10.

The module is the reference's ``nn.Sequential`` of those 29 layers, so its
``state_dict`` names are the reference's: ``{0,2,5,7,10,12,14,17,19,21,24,
26,28}.{weight,bias}`` (``encoder.N.*`` inside the descriptor model).

Layout: NHWC in, NHWC out, as in JAX. The (B, S, S, 3) input is permuted
once to an NCHW view, which is channels-last in memory, so cuDNN runs the
stack in NHWC; the (B, 512, S/16, S/16) output is permuted back for NetVLAD.
Convs run in ``compute_dtype`` (bf16 by default, as in JAX: each conv's
output, bias included, is rounded to bf16), the result is float32. Every
conv and max-pool goes through the forward's ``ops``
(``models/layer_ops.py``), which the spatial partition replaces. With
``l2_normalize_output`` the fp32 output is L2-normalised over channels
(the reference's cluster mode appends an L2Norm, main.py:568).

``load_torchvision_npz`` loads the ImageNet backbone's ``.npz`` (the JAX
package's layout, ``tools/convert_torch_checkpoint.py``) into an encoder.

The JAX package's ``vgg_pack_width`` (``PackedPairConv``: the first block on
a width-pair-packed layout) is a TPU lane trick with the canonical parameter
tree; in fp32 it equals the plain convs up to summation order. The port
ignores the flag and always runs the plain convs on the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from gloc3d_tpu_torch.models.layer_ops import PLAIN, LayerOps
from gloc3d_tpu_torch.models.netvlad import l2_normalize

# (channels, pool_before) for the 13 convs of VGG16-D
VGG16_CFG = (
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
)
# torchvision vgg16.features index of each conv (features[:-2] keeps all 13)
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def conv_flops(batch: int, size: int) -> int:
    """Floating-point operations (2 per multiply-add) of one forward of the
    13 convs on ``batch`` images of ``size``² pixels."""
    total, cin, s = 0, 3, size
    for cout, pool in VGG16_CFG:
        if pool:
            s //= 2
        total += 2 * batch * s * s * cout * cin * 9
        cin = cout
    return total


def trainable_mask(model: nn.Module, train_from_conv: int = 10
                   ) -> Dict[str, bool]:
    """``{parameter name: bool}`` over a whole VGG16 DescriptorModel: True
    for the convs from ``train_from_conv`` on (the reference freezes
    everything below conv5_1, conv index 10, when pretrained:
    main.py:538-541), False for every other parameter, the pooling's too,
    as the JAX function gives over a whole parameter tree."""
    prefixes = tuple(f"encoder.{i}." for i in VGG16_CONV_IDX[train_from_conv:])
    return {name: name.startswith(prefixes)
            for name, _ in model.named_parameters()}


def load_torchvision_npz(encoder: "VGG16Encoder", npz_path: str
                         ) -> "VGG16Encoder":
    """Load converted torchvision VGG16 weights into ``encoder`` in place:
    the ``.npz`` of ``tools/convert_torch_checkpoint.py`` holds
    ``conv{i}_kernel`` (H, W, I, O) and ``conv{i}_bias`` (O,) for the 13
    convs, in the JAX package's layout; here they become the convs at the
    reference's ``{0, 2, …, 28}`` (O, I, H, W). Returns ``encoder``."""
    with np.load(npz_path) as data:
        state = {}
        for i, li in enumerate(VGG16_CONV_IDX):
            state[f"{li}.weight"] = torch.from_numpy(
                data[f"conv{i}_kernel"]).permute(3, 2, 0, 1).contiguous()
            state[f"{li}.bias"] = torch.from_numpy(data[f"conv{i}_bias"])
    encoder.load_state_dict(state)
    return encoder


def nhwc_output(x: torch.Tensor, l2_normalize_output: bool
                ) -> torch.Tensor:
    """An encoder's NCHW map → its NHWC float32 output, L2-normalised over
    channels when ``l2_normalize_output``."""
    x = x.float().permute(0, 2, 3, 1)
    return l2_normalize(x) if l2_normalize_output else x


class VGG16Encoder(nn.Sequential):
    """13-conv VGG16 feature extractor ending at conv5_3 (no ReLU / pool)."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 l2_normalize_output: bool = False):
        layers, cin = [], 3
        for i, (cout, pool) in enumerate(VGG16_CFG):
            if pool:
                layers.append(nn.MaxPool2d(2, 2))
            layers.append(nn.Conv2d(cin, cout, 3, padding=1))
            if i < len(VGG16_CFG) - 1:
                layers.append(nn.ReLU(inplace=True))
            cin = cout
        super().__init__(*layers)
        self.compute_dtype = compute_dtype
        self.l2_normalize_output = l2_normalize_output

    def forward(self, x: torch.Tensor, ops: LayerOps = PLAIN) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2)  # NHWC → NCHW view, channels last
        for m in self:
            if isinstance(m, nn.Conv2d):
                x = ops.conv(m, x, cd)
            elif isinstance(m, nn.MaxPool2d):
                x = ops.max_pool(m, x)
            else:
                x = m(x)
        return nhwc_output(x, self.l2_normalize_output)
