"""The i2i image encoders: VGG16 and the AlexNet / MobileNetV2 / ResNet18
baselines.

Port of ``gloc3d_tpu/models/encoders.py``. The reference builds each as the
torchvision backbone truncated to its feature extractor, wrapped in an
``nn.Sequential`` (main.py:519-564):

  alexnet    features[:-2]       → 256-ch map at stride 16 (after 2 pools)
  vgg16      features[:-2]       → 512-ch map at stride 16 (models/vgg.py)
  mobilenet  features[:-1]       → 320-ch map at stride 32
  resnet18   children()[:-2]     → 512-ch map at stride 32

Each module here is that ``nn.Sequential``, so its ``state_dict`` names are
the reference's: torchvision's ``features.*`` names without the prefix
(alexnet, mobilenet), and for resnet18 the Sequential's indices (``0`` =
conv1, ``1`` = bn1, ``4``-``7`` = layer1-layer4). ``torchvision_state_dict``
is the inverse of the JAX package's ``convert_torchvision_encoder``: a Flax
encoder tree → torchvision's full-model names; ``port_key`` maps those to
the module's own.

NHWC in, NHWC float32 out, as in JAX. Convs run in ``compute_dtype``;
BatchNorm runs in float32 with Flax's momentum 0.9 (torch 0.1) and eps 1e-5
and Flax's biased running variance (``models/batchnorm.py``). Padding is
explicit in JAX and the same here: AlexNet's 3×3/2 pools are VALID,
ResNet's max-pool pads with −inf as ``F.max_pool2d(padding=1)`` does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gloc3d_tpu_torch.config import ENCODER_DIMS
from gloc3d_tpu_torch.models.batchnorm import BatchNorm
from gloc3d_tpu_torch.models.vgg import VGG16_CONV_IDX, VGG16Encoder

# MobileNetV2 inverted-residual plan, torchvision features[1..17]:
# (expand_ratio, out_ch, stride) per block
MBV2_BLOCKS: Tuple[Tuple[int, int, int], ...] = (
    (1, 16, 1),
    (6, 24, 2), (6, 24, 1),
    (6, 32, 2), (6, 32, 1), (6, 32, 1),
    (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
    (6, 96, 1), (6, 96, 1), (6, 96, 1),
    (6, 160, 2), (6, 160, 1), (6, 160, 1),
    (6, 320, 1),
)
_ALEXNET_CONV_IDX = (0, 3, 6, 8, 10)


def is_image_encoder(name: str) -> bool:
    return name in ENCODER_DIMS


def _conv(m: nn.Conv2d, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``m`` applied in ``cd`` (input, weight and bias rounded to it)."""
    bias = None if m.bias is None else m.bias.to(cd)
    return F.conv2d(x.to(cd), m.weight.to(cd), bias, m.stride, m.padding,
                    groups=m.groups)


def _nchw(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return x.to(cd).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 2, 3, 1)


class AlexNetEncoder(nn.Sequential):
    """torchvision alexnet ``features[:-2]``: five convs, ReLU after all but
    the last, 3×3/2 max-pools after the first two."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 256, 3, padding=1))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = _nchw(x, cd)
        for m in self:
            x = _conv(m, x, cd) if isinstance(m, nn.Conv2d) else m(x)
        return _nhwc(x)


class _ConvBNReLU6(nn.Sequential):
    """torchvision's ``Conv2dNormActivation``: conv (no bias), BN, ReLU6."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(
            nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                      bias=False),
            BatchNorm(cout), nn.ReLU6(inplace=True))

    def run(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        return F.relu6(self[1](_conv(self[0], x, cd).float())).to(cd)


class _InvertedResidual(nn.Module):
    """torchvision's ``InvertedResidual``: ``conv`` is [expand (t ≠ 1),
    depthwise, project conv, BN]; a residual when stride 1 and in = out."""

    def __init__(self, cin: int, cout: int, stride: int, t: int):
        super().__init__()
        hidden = cin * t
        layers = [_ConvBNReLU6(cin, hidden, 1)] if t != 1 else []
        layers += [_ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), BatchNorm(cout)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def run(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        y = x
        for m in self.conv[:-2]:
            y = m.run(y, cd)
        y = self.conv[-1](_conv(self.conv[-2], y, cd).float()).to(cd)
        return y + x if self.use_res else y


class MobileNetV2Encoder(nn.Sequential):
    """torchvision mobilenet_v2 ``features[:-1]``: stem ConvBNReLU6(32, /2)
    and 17 inverted residual blocks; the final 1×1 1280-ch layer dropped."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16):
        layers, cin = [_ConvBNReLU6(3, 32, 3, 2)], 32
        for t, ch, s in MBV2_BLOCKS:
            layers.append(_InvertedResidual(cin, ch, s, t))
            cin = ch
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = _nchw(x, cd)
        for m in self:
            x = m.run(x, cd)
        return _nhwc(x)


class _BasicBlock(nn.Module):
    """torchvision's resnet ``BasicBlock`` (attribute names included)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, cout, 1, stride, bias=False), BatchNorm(cout))
            if stride != 1 or cin != cout else None)

    def run(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x, cd).float())).to(cd)
        y = self.bn2(_conv(self.conv2, y, cd).float())
        identity = x if self.downsample is None else self.downsample[1](
            _conv(self.downsample[0], x, cd).float())
        return F.relu(y + identity.float()).to(cd)


class ResNet18Encoder(nn.Sequential):
    """torchvision resnet18 ``children()[:-2]``: conv1 (7×7/2), bn1, ReLU,
    max-pool (3/2, pad 1), layer1-layer4 of two BasicBlocks each."""

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16):
        layers = [nn.Conv2d(3, 64, 7, 2, 3, bias=False), BatchNorm(64),
                  nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1)]
        cin = 64
        for li, ch in enumerate((64, 128, 256, 512), start=1):
            stride = 1 if li == 1 else 2
            layers.append(nn.Sequential(_BasicBlock(cin, ch, stride),
                                        _BasicBlock(ch, ch, 1)))
            cin = ch
        super().__init__(*layers)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = F.relu(self[1](_conv(self[0], _nchw(x, cd), cd).float())).to(cd)
        x = self[3](x)
        for layer in list(self)[4:]:
            for block in layer:
                x = block.run(x, cd)
        return _nhwc(x)


def build_image_encoder(name: str, compute_dtype: torch.dtype) -> nn.Module:
    """The encoder ``name`` with its conv weights channels-last in memory
    (loading and casting keep the layout), as its activations are: cuDNN
    then takes the weights as they are instead of reordering them on every
    call."""
    cls = {"vgg16": VGG16Encoder, "alexnet": AlexNetEncoder,
           "mobilenet": MobileNetV2Encoder, "resnet18": ResNet18Encoder}
    if name not in cls:
        raise ValueError(f"unknown image encoder {name!r}")
    return cls[name](compute_dtype).to(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# the reference's pretrained freeze rules (main.py:519-564)

_TRAINABLE = {  # the modules that train, in torchvision's names
    "alexnet": ("features.10.",),                  # conv4, the last conv
    "vgg16": tuple(f"{i}." for i in VGG16_CONV_IDX[10:]),  # conv5_1-5_3
    "mobilenet": ("features.16.", "features.17."),  # the last two blocks
    "resnet18": ("layer3.", "layer4."),
}


def encoder_trainable_prefixes(name: str) -> Tuple[str, ...]:
    """Prefixes of the DescriptorModel parameter names that TRAIN under the
    reference's pretrained freeze rules; the rest of the encoder is frozen.
    alexnet: layers[:-1] frozen, only the last conv trains; vgg16:
    layers[:-5] frozen, conv5_1-5_3 (``encoder.24/26/28``) train;
    mobilenet: layers[:-2] frozen, the last two inverted residuals train;
    resnet18: layers[:-2] frozen, layer3 and layer4 train."""
    if name == "vgg16":
        return tuple(f"encoder.{p}" for p in _TRAINABLE[name])
    return tuple(f"encoder.{port_key(name, p)}" for p in _TRAINABLE[name])


def encoder_trainable_mask(name: str, model: nn.Module) -> Dict[str, bool]:
    """``{parameter name: bool}`` over a DescriptorModel's encoder
    parameters: True where the name lies under ``encoder_trainable_
    prefixes``."""
    prefixes = encoder_trainable_prefixes(name)
    return {k: k.startswith(prefixes) for k, _ in model.named_parameters()
            if k.startswith("encoder.")}


def train_mask(model: nn.Module, encoder: str, fromscratch: bool = False
               ) -> Optional[Dict[str, bool]]:
    """The mask ``Trainer(trainable_mask=...)`` takes, built as the JAX
    package's ``cmd_train`` builds it: for a pretrained image encoder the
    encoder follows ``encoder_trainable_mask`` and every other parameter
    trains; None (everything trains) for PointPillar or from scratch."""
    if not is_image_encoder(encoder) or fromscratch:
        return None
    mask = {k: True for k, _ in model.named_parameters()}
    mask.update(encoder_trainable_mask(encoder, model))
    return mask


# ---------------------------------------------------------------------------
# Flax encoder trees → torchvision names (the inverse of the JAX package's
# convert_torchvision_encoder)

def _oihw(kernel) -> torch.Tensor:
    """Flax (kH, kW, I, O) → torch (O, I, kH, kW)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def torchvision_state_dict(name: str, params: Mapping, batch_stats: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """An AlexNet / MobileNetV2 / ResNet18 Flax encoder's ``params`` and
    ``batch_stats`` → a state dict with torchvision's full-model names
    (``features.N.*``; ``conv1`` / ``bn1`` / ``layerL.B.*``), which
    ``convert_torchvision_encoder`` maps back to the same trees."""
    out: Dict[str, torch.Tensor] = {}

    def conv(src, dst):
        out[f"{dst}.weight"] = _oihw(params[src]["kernel"])
        if "bias" in params[src]:
            out[f"{dst}.bias"] = _t(params[src]["bias"])

    def bn(src, dst):
        out[f"{dst}.weight"] = _t(params[src]["scale"])
        out[f"{dst}.bias"] = _t(params[src]["bias"])
        out[f"{dst}.running_mean"] = _t(batch_stats[src]["mean"])
        out[f"{dst}.running_var"] = _t(batch_stats[src]["var"])
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    if name == "alexnet":
        for i, li in enumerate(_ALEXNET_CONV_IDX):
            conv(f"conv{i}", f"features.{li}")
    elif name == "mobilenet":
        conv("stem_conv", "features.0.0")
        bn("stem_bn", "features.0.1")
        for bi, (t, _, _) in enumerate(MBV2_BLOCKS, start=1):
            base, off = f"features.{bi}.conv", 0
            if t != 1:
                conv(f"block{bi}_expand_conv", f"{base}.0.0")
                bn(f"block{bi}_expand_bn", f"{base}.0.1")
                off = 1
            conv(f"block{bi}_dw_conv", f"{base}.{off}.0")
            bn(f"block{bi}_dw_bn", f"{base}.{off}.1")
            conv(f"block{bi}_project_conv", f"{base}.{off + 1}")
            bn(f"block{bi}_project_bn", f"{base}.{off + 2}")
    elif name == "resnet18":
        conv("conv1", "conv1")
        bn("bn1", "bn1")
        for li in range(1, 5):
            for b in range(2):
                src, pre = f"layer{li}.{b}", f"layer{li}_block{b}"
                for part in ("conv1", "conv2"):
                    conv(f"{pre}_{part}", f"{src}.{part}")
                for part in ("bn1", "bn2"):
                    bn(f"{pre}_{part}", f"{src}.{part}")
                if f"{pre}_down_conv" in params:
                    conv(f"{pre}_down_conv", f"{src}.downsample.0")
                    bn(f"{pre}_down_bn", f"{src}.downsample.1")
    else:
        raise ValueError(f"unknown encoder {name!r}")
    return out


def port_key(name: str, key: str) -> str:
    """A torchvision full-model key → the encoder module's own key (the
    reference's ``nn.Sequential`` of the truncated backbone)."""
    if name in ("alexnet", "mobilenet"):
        return key[len("features."):]
    head, rest = key.split(".", 1)
    index = {"conv1": "0", "bn1": "1"}.get(head)
    if index is None:  # layerL → the Sequential's index 3 + L
        index = str(3 + int(head[len("layer"):]))
    return f"{index}.{rest}"
