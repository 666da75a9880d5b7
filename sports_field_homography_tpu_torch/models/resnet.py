"""ResNet Spatial Transformer head (port of ``models/resnet.py``).

torchvision-style ResNet with a 7x7 stem over any number of input
channels and a 9-way linear head that emits a 3x3 homography.  It runs
on cuDNN (the JAX package has no Pallas kernel here) on channels-last
views; BN is computed in f32 and cast back, as in the JAX package, with
batch moments and a running-stat update in training mode
(``layers.bn_train``).  Only the basic-block variants (resnet18,
resnet34) are ported so far.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import bn_apply, nchw

__all__ = ["BasicBlock", "ResNetSTN", "resnet_models"]

_IDENTITY_THETA = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
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
        t = self.training
        out = torch.relu(bn_apply(_conv(x, self.conv1), self.bn1, t))
        out = bn_apply(_conv(out, self.conv2), self.bn2, t)
        identity = x
        if self.downsample is not None:
            identity = bn_apply(_conv(x, self.downsample[0]), self.downsample[1], t)
        return torch.relu(out + identity)


resnet_models = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
}


class ResNetSTN(nn.Module):
    """ResNet backbone + 3x3 homography regression head.

    ``forward`` takes NHWC input in the compute dtype and returns theta
    (B, 1, 3, 3) in float32.
    """

    def __init__(self, block, layers: Sequence[int], in_channels: int):
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
                seq.append(block(inplanes, planes, s, need_ds))
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
        x = torch.relu(bn_apply(_conv(x, self.conv0), self.bn1, self.training))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        x = x.mean(dim=(2, 3))            # AdaptiveAvgPool2d((1, 1))
        theta = F.linear(x.float(), self.reg.weight.float(), self.reg.bias.float())
        return theta.view(-1, 1, 3, 3)
