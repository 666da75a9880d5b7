"""UNet court segmentation, deconv or bilinear variant (port of
``models/unet.py``).

Activations are NHWC.  Every 3x3 conv except the 3-channel stem runs K2
(``ops/double_conv.py``) and every BN2+ReLU K7-fwd's norm; a decoder
DoubleConv takes the skip and the up-sampled tensor as K2's two inputs,
with no concat.  The deconv variant up-samples with K3 (``ops/deconv.py``),
the bilinear one with ``ops/resize.upsample2x_bilinear`` and halves the
deepest widths (down4 512, decoder outputs 256/128/64/64 with mids
512/256/128/64).  In training mode each DoubleConv runs the
``double_conv_train`` autograd Function (K2 with stats, K5, K7-fwd,
K7-bwd) and updates its BN running stats; the up-convs' backward is
K3-bwd.  Parameter
names follow the reference (``inc.double_conv.0.weight``,
``down1.maxpool_conv.1.double_conv...``, ``up1.up.weight``,
``outc.conv.weight``).  The reference inlines these layers into its
Reconstructor, so ``unet_layers`` builds them for it to hold and
``unet_forward`` runs them on the module that holds them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deconv import deconv2x2
from ..ops.double_conv import double_conv_eval, double_conv_train
from ..ops.resize import upsample2x_bilinear
from .layers import BN_EPS, max_pool, update_running_stats

__all__ = ["DoubleConv", "Down", "Up", "OutConv", "unet_layers", "unet_forward"]


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


class DoubleConv(nn.Module):
    """(conv3x3 pad1 -> BN -> ReLU) x 2 (reference ``unet/unet_parts.py``);
    ``forward(x, x2)`` runs conv1 on the channel concat [x, x2]."""

    bn_sync = None           # models/layers.set_bn_sync

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1),
            nn.BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, 3, padding=1),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def conv_bn_pairs(self):
        s = self.double_conv
        return [(s[0], s[1]), (s[3], s[4])]

    def forward(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        c1, bn1, _, c2, bn2, _ = self.double_conv
        if self.training:
            out, m1, v1, m2, v2 = double_conv_train(
                x, _hwio(c1.weight), c1.bias, bn1.weight, bn1.bias,
                _hwio(c2.weight), c2.bias, bn2.weight, bn2.bias, BN_EPS, x2=x2,
                sync=self.bn_sync)
            n = x.shape[0] * x.shape[1] * x.shape[2]
            if self.bn_sync is not None:
                n = self.bn_sync.count(n)
            update_running_stats(bn1, m1, v1, n)
            update_running_stats(bn2, m2, v2, n)
            return out
        return double_conv_eval(
            x, _hwio(c1.weight), c1.bias, bn1.weight, bn1.bias,
            bn1.running_mean, bn1.running_var,
            _hwio(c2.weight), c2.bias, bn2.weight, bn2.bias,
            bn2.running_mean, bn2.running_var, BN_EPS, x2=x2)


class Down(nn.Module):
    """2x2 max-pool, then DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(in_channels, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv[1](max_pool(x, 2, 2))


class Up(nn.Module):
    """Up-sample (k2s2 up-conv on K3, or bilinear 2x), pad to the skip's
    size, DoubleConv over [skip, up] (K2's two-input form: no concat).

    ``in_channels`` is the concat's width, as in the reference; the
    bilinear variant has no ``up`` parameters and a DoubleConv of mid
    width ``in_channels // 2``."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = False):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2)
        else:
            self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
            self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.bilinear:
            x1 = upsample2x_bilinear(x1)
        else:
            x1 = deconv2x2(x1, self.up.weight.permute(0, 2, 3, 1), self.up.bias)
        # align to the skip: F.pad([dx//2, dx-dx//2, dy//2, dy-dy//2])
        dy = x2.shape[1] - x1.shape[1]
        dx = x2.shape[2] - x1.shape[2]
        if dy or dx:
            x1 = F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.conv(x2, x1)


class OutConv(nn.Module):
    """1x1 projection head."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return F.linear(x, self.conv.weight[:, :, 0, 0].to(dt),
                        self.conv.bias.to(dt))


def unet_layers(mask_classes: int = 4, uv: bool = False,
                bilinear: bool = False) -> Dict[str, nn.Module]:
    """The UNet's layers by reference name: channels 64..1024 (the deepest
    halved when bilinear), 4 skips."""
    f = 2 if bilinear else 1
    layers = {
        "inc": DoubleConv(3, 64),
        "down1": Down(64, 128), "down2": Down(128, 256),
        "down3": Down(256, 512), "down4": Down(512, 1024 // f),
        "up1": Up(1024, 512 // f, bilinear), "up2": Up(512, 256 // f, bilinear),
        "up3": Up(256, 128 // f, bilinear), "up4": Up(128, 64, bilinear),
        "outc": OutConv(64, mask_classes),
    }
    if uv:
        layers["outuv"] = OutConv(64, 2)
    return layers


def unet_forward(m: nn.Module, x: torch.Tensor):
    """Run the UNet layers held by ``m`` on NHWC ``x`` (in the compute
    dtype).  Returns (logits, bottleneck, uv or None), all NHWC."""
    x1 = m.inc(x)
    x2 = m.down1(x1)
    x3 = m.down2(x2)
    x4 = m.down3(x3)
    x_top = m.down4(x4)
    y = m.up1(x_top, x4)
    y = m.up2(y, x3)
    y = m.up3(y, x2)
    y = m.up4(y, x1)
    logits = m.outc(y)
    uv = m.outuv(y) if hasattr(m, "outuv") else None
    return logits, x_top, uv

