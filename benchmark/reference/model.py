"""The plain reference: the court reconstructor in plain PyTorch, NCHW,
float32.

UNet (milesial/Pytorch-UNet, deconv or ``bilinear=True``), a torchvision
ResNet (BasicBlock or the v1.5 Bottleneck) with a 7x7 stem over the
image and the UNet's logits and a 9-way head that emits a 3x3 homography,
as the original reference (github.com/darkAlert/sports-field-homography)
builds them.  The trunks follow torchvision's definitions of the papers:
ResNet (He et al., arXiv:1512.03385), ResNeXt (Xie et al.,
arXiv:1611.05431: grouped 3x3 convs) and the wide ResNets (Zagoruyko &
Komodakis, arXiv:1605.07146, as torchvision's ``wide_resnet*_2``: twice
the Bottleneck's inner width).  Parameter names are that reference's, so one state dict
loads here and into the system under test.  Nothing here imports the
system under test.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Reconstructor", "RESNETS"]


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=None):
        super().__init__()
        mid = mid or cout
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, padding=1), nn.BatchNorm2d(mid), nn.ReLU(inplace=True),
            nn.Conv2d(mid, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin, cout, bilinear):
        super().__init__()
        if bilinear:
            self.up = nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)
            self.conv = DoubleConv(cin, cout, cin // 2)
        else:
            self.up = nn.ConvTranspose2d(cin, cin // 2, 2, stride=2)
            self.conv = DoubleConv(cin, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dy = x2.shape[2] - x1.shape[2]
        dx = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock takes groups=1 and base_width=64 only")
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3 (the stride and the groups), 1x1 to ``planes * 4``; the
    inner width is ``int(planes * base_width / 64) * groups``."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1, base_width=64):
        super().__init__()
        width = int(planes * base_width / 64) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


# name -> (block, blocks a stage, groups, width per group)
RESNETS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), 1, 128),
}


class ResNetSTN(nn.Module):
    def __init__(self, name, in_channels):
        super().__init__()
        if name not in RESNETS:
            raise KeyError(f"no ResNet {name!r} in the reference; it builds {sorted(RESNETS)}")
        block, layers, groups, base_width = RESNETS[name]
        self.conv0 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                ds = None
                if b == 0 and (s != 1 or inplanes != planes * block.expansion):
                    ds = nn.Sequential(nn.Conv2d(inplanes, planes * block.expansion, 1, s,
                                                 bias=False),
                                       nn.BatchNorm2d(planes * block.expansion))
                blocks.append(block(inplanes, planes, s, ds, groups, base_width))
                inplanes = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.reg = nn.Linear(512 * block.expansion, 9)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv0(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = torch.flatten(F.adaptive_avg_pool2d(x, 1), 1)
        return self.reg(x).view(-1, 3, 3)


class Reconstructor(nn.Module):
    """UNet layers at the top level and the ResNet under ``resnet_reg``;
    the ResNet reads ``cat([logits, image])`` (``resnet_input: img+mask``)."""

    def __init__(self, mask_classes=4, bilinear=False, resnet_name="resnet34"):
        super().__init__()
        f = 2 if bilinear else 1
        self.inc = DoubleConv(3, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024 // f)
        self.up1 = Up(1024, 512 // f, bilinear)
        self.up2 = Up(512, 256 // f, bilinear)
        self.up3 = Up(256, 128 // f, bilinear)
        self.up4 = Up(128, 64, bilinear)
        self.outc = OutConv(64, mask_classes)
        self.resnet_reg = ResNetSTN(resnet_name, mask_classes + 3)

    def unet(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        return self.outc(self.up4(y, x1))

    def forward(self, x):
        """x: (B, 3, H, W) in [0, 1].  Returns logits (B, C, H, W) and
        theta (B, 3, 3), frame -> court in [-1, 1] coordinates."""
        logits = self.unet(x)
        theta = self.resnet_reg(torch.cat([logits, x], dim=1))
        return logits, theta
