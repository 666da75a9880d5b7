"""ResNet Spatial Transformer head (port of ``models/resnet.py``).

torchvision-style ResNet with a 7x7 stem over any number of input
channels and a 9-way linear head that emits a 3x3 homography.  It runs
on cuDNN (the JAX package has no Pallas kernel here) on channels-last
views; BN is computed in f32 and cast back, as in the JAX package, with
batch moments and a running-stat update in training mode
(``layers.bn_train``).  Every JAX variant is here: resnet18/34 on the
basic block, resnet50/101/152, resnext50_32x4d/101_32x8d and
wide_resnet50_2/101_2 on the bottleneck, and the reference's ``resnet52``
alias for resnet152.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import bn_apply, nchw

__all__ = ["BasicBlock", "Bottleneck", "ResNetSTN", "resnet_models"]

_IDENTITY_THETA = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding, 1, conv.groups)


class BasicBlock(nn.Module):
    expansion = 1
    bn_sync = None           # models/layers.set_bn_sync

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock takes groups=1 and base_width=64 only")
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=False),
            nn.BatchNorm2d(planes)) if downsample else None)

    def conv_bn_pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2)]
        if self.downsample is not None:
            pairs.append((self.downsample[0], self.downsample[1]))
        return pairs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, sync = self.training, self.bn_sync
        out = torch.relu(bn_apply(_conv(x, self.conv1), self.bn1, t, sync=sync))
        out = bn_apply(_conv(out, self.conv2), self.bn2, t, sync=sync)
        identity = x
        if self.downsample is not None:
            identity = bn_apply(_conv(x, self.downsample[0]), self.downsample[1], t,
                                sync=sync)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride, and the groups of ResNeXt) -> 1x1 with 4x
    expansion, torchvision's "v1.5" placement; width
    ``planes * base_width / 64 * groups``."""

    expansion = 4
    bn_sync = None

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride, bias=False),
            nn.BatchNorm2d(out)) if downsample else None)

    def conv_bn_pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        if self.downsample is not None:
            pairs.append((self.downsample[0], self.downsample[1]))
        return pairs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, sync = self.training, self.bn_sync
        out = torch.relu(bn_apply(_conv(x, self.conv1), self.bn1, t, sync=sync))
        out = torch.relu(bn_apply(_conv(out, self.conv2), self.bn2, t, sync=sync))
        out = bn_apply(_conv(out, self.conv3), self.bn3, t, sync=sync)
        identity = x
        if self.downsample is not None:
            identity = bn_apply(_conv(x, self.downsample[0]), self.downsample[1], t,
                                sync=sync)
        return torch.relu(out + identity)


# name -> ResNetSTN arguments (the JAX ``RESNET_SPECS``)
resnet_models = {
    "resnet18": dict(block=BasicBlock, layers=(2, 2, 2, 2)),
    "resnet34": dict(block=BasicBlock, layers=(3, 4, 6, 3)),
    "resnet50": dict(block=Bottleneck, layers=(3, 4, 6, 3)),
    "resnet101": dict(block=Bottleneck, layers=(3, 4, 23, 3)),
    "resnet152": dict(block=Bottleneck, layers=(3, 8, 36, 3)),
    "resnext50_32x4d": dict(block=Bottleneck, layers=(3, 4, 6, 3), groups=32,
                            width_per_group=4),
    "resnext101_32x8d": dict(block=Bottleneck, layers=(3, 4, 23, 3), groups=32,
                             width_per_group=8),
    "wide_resnet50_2": dict(block=Bottleneck, layers=(3, 4, 6, 3), width_per_group=128),
    "wide_resnet101_2": dict(block=Bottleneck, layers=(3, 4, 23, 3), width_per_group=128),
}
# the reference registers resnet152 under 'resnet52' as well
resnet_models["resnet52"] = resnet_models["resnet152"]


class ResNetSTN(nn.Module):
    """ResNet backbone + 3x3 homography regression head.

    ``forward`` takes NHWC input in the compute dtype and returns theta
    (B, 1, 3, 3) in float32.
    """
    bn_sync = None

    def __init__(self, block, layers: Sequence[int], in_channels: int,
                 groups: int = 1, width_per_group: int = 64):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            stride = 1 if stage == 0 else 2
            seq = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                need_ds = bi == 0 and (s != 1 or inplanes != planes * block.expansion)
                seq.append(block(inplanes, planes, s, need_ds, groups, width_per_group))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*seq))
        self.reg = nn.Linear(512 * block.expansion, 9)

    def conv_bn_pairs(self):
        return [(self.conv0, self.bn1)]

    @torch.no_grad()
    def reset_parameters_from(self, generator: torch.Generator) -> None:
        """kaiming_normal(fan_out, relu) convs and the identity-initialised
        head (zero weight, identity bias), as the reference does."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                std = math.sqrt(2.0 / fan_out)
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
        self.reg.weight.zero_()
        self.reg.bias.copy_(torch.tensor(_IDENTITY_THETA))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x)                       # channels-last view
        x = torch.relu(bn_apply(_conv(x, self.conv0), self.bn1, self.training,
                                sync=self.bn_sync))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        x = x.mean(dim=(2, 3))            # AdaptiveAvgPool2d((1, 1))
        theta = F.linear(x.float(), self.reg.weight.float(), self.reg.bias.float())
        return theta.view(-1, 1, 3, 3)
