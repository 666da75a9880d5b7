"""The legacy model family (port of ``models/legacy.py``): a standalone
segmentation ``UNet``, ``UNetSTN`` (UNet + an affine 2x3 STN that samples
the template) and ``CourtReconstruction`` (UNet + a 3x3 homography
regressed from the bottleneck + the template's bilinear warp).

All three run the port's UNet (``models/unet.py``: K2, K7-fwd's norm, and
K3 when ``bilinear`` is false), with its layers held directly on the model
as the Reconstructor holds them, so the UNet's ``state_dict`` keys are the
Reconstructor's.  The regression head is ``reg`` (``reg.conv_reg``,
``reg.fc1``, ``reg.fc2``).  Frames are NHWC float32 in [0, 1], run in
the model's compute dtype; the head's last layer runs in float32.

The head flattens an 8-channel bottleneck, so ``fc1``'s width depends on
the input size: ``input_size`` (``UNetSTN``) or ``target_size``
(``CourtReconstruction``), (W, H), 640x360 by default (an 8 x 22 x 40
bottleneck, as the reference hard-codes it).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.warp import sample_bilinear, warp_bilinear
from .unet import unet_forward, unet_layers

__all__ = ["UNet", "UNetSTN", "CourtReconstruction", "bottleneck_hw"]


def bottleneck_hw(size) -> tuple:
    """(h, w) of the UNet's bottleneck for an input of ``size`` = (W, H):
    four 2x2 max-pools, each rounding down."""
    w, h = int(size[0]), int(size[1])
    for _ in range(4):
        w, h = w // 2, h // 2
    return h, w


class _UNetModel(nn.Module):
    """Holds the UNet's layers under their reference names."""

    def __init__(self, n_classes: int, bilinear: bool, dtype: torch.dtype):
        super().__init__()
        self.n_classes = n_classes
        self.bilinear = bilinear
        self.dtype = dtype
        for name, layer in unet_layers(n_classes, bilinear=bilinear).items():
            self.add_module(name, layer)

    def _unet(self, x: torch.Tensor):
        return unet_forward(self, x.to(self.dtype).contiguous())


class UNet(_UNetModel):
    """Segmentation UNet: ``forward(x)`` gives NHWC logits of
    ``n_classes`` channels in the compute dtype."""

    def __init__(self, n_classes: int, bilinear: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(n_classes, bilinear, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._unet(x)[0]


class _BottleneckReg(nn.Module):
    """conv1x1 (-> 8) -> flatten in (c, h, w) order -> Linear(8*h*w, 32)
    -> ReLU -> Linear(32, out_dim) in float32, whose weight starts at 0
    and bias at ``identity``."""

    def __init__(self, in_channels: int, bottleneck: Sequence[int], out_dim: int,
                 identity: Sequence[float]):
        super().__init__()
        h, w = bottleneck
        self.identity = tuple(float(v) for v in identity)
        self.conv_reg = nn.Conv2d(in_channels, 8, 1)
        self.fc1 = nn.Linear(8 * h * w, 32)
        self.fc2 = nn.Linear(32, out_dim)
        self.reset_head()

    @torch.no_grad()
    def reset_head(self) -> None:
        self.fc2.weight.zero_()
        self.fc2.bias.copy_(torch.tensor(self.identity))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.linear(x, self.conv_reg.weight[:, :, 0, 0].to(dt), self.conv_reg.bias.to(dt))
        y = y.permute(0, 3, 1, 2).reshape(y.shape[0], -1)    # NHWC -> (c, h, w) order
        y = F.relu(F.linear(y, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        return F.linear(y.float(), self.fc2.weight.float(), self.fc2.bias.float())


def _template_batch(template: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` of a (B, Ht, Wt[, C]) template batch, channel 0, as
    (n, Ht, Wt) float32; a (Ht, Wt) template serves every sample."""
    t = template.float()
    if t.dim() == 2:
        return t.expand(n, *t.shape)
    if t.dim() == 4:
        t = t[..., 0]
    return t[:n]


class UNetSTN(_UNetModel):
    """UNet + affine STN: ``forward(x, template)`` gives (logits, proj),
    proj the template sampled through theta's affine grid (B, Ht, Wt)."""

    def __init__(self, n_classes: int, bilinear: bool = True, input_size=(640, 360),
                 dtype: torch.dtype = torch.float32):
        super().__init__(n_classes, bilinear, dtype)
        self.input_size = tuple(input_size)
        self.reg = _BottleneckReg(1024 // (2 if bilinear else 1), bottleneck_hw(input_size),
                                  6, (1, 0, 0, 0, 1, 0))

    def forward(self, x: torch.Tensor, template: torch.Tensor):
        logits, x_top, _ = self._unet(x)
        return logits, self.project(self.reg(x_top).reshape(-1, 2, 3), template)

    @staticmethod
    def project(theta: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
        """The template sampled through the affine grid of (B, 2, 3) theta
        (``affine_grid``, then a bilinear ``grid_sample``, both
        ``align_corners=False``, zeros outside): (B, Ht, Wt).  The grid is
        ``theta @ (x, y, 1)`` written out term by term over the pixel
        centres, so that the CPU and CUDA compute the same bits.  The
        centres are computed on the host: CUDA divides a tensor by a scalar
        as a product with its reciprocal, which moves them by an ulp."""
        t = _template_batch(template, theta.shape[0]).to(theta.device)
        th, tw = t.shape[1:]
        ys = (torch.arange(th, dtype=torch.float32) + 0.5) / th * 2.0 - 1.0
        xs = (torch.arange(tw, dtype=torch.float32) + 0.5) / tw * 2.0 - 1.0
        x, y = xs.view(1, 1, -1).to(t.device), ys.view(1, -1, 1).to(t.device)
        a = theta.float().reshape(-1, 6, 1, 1)

        def row(i):
            return (a[:, 3 * i] * x + a[:, 3 * i + 1] * y) + a[:, 3 * i + 2]

        return sample_bilinear(t, torch.stack([row(0), row(1)], dim=-1))


class CourtReconstruction(_UNetModel):
    """UNet + a 3x3 homography from the bottleneck + the template's
    bilinear warp at ``target_size``: ``forward(x, template)`` gives
    (logits, proj (B, H, W))."""

    def __init__(self, n_classes: int, target_size=(640, 360), bilinear: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(n_classes, bilinear, dtype)
        self.target_size = tuple(target_size)
        self.reg = _BottleneckReg(1024 // (2 if bilinear else 1), bottleneck_hw(target_size),
                                  9, (1, 0, 0, 0, 1, 0, 0, 0, 1))

    def forward(self, x: torch.Tensor, template: torch.Tensor):
        logits, x_top, _ = self._unet(x)
        return logits, self.project(self.reg(x_top).reshape(-1, 3, 3), template)

    def project(self, theta: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
        """The template's bilinear warp by (B, 3, 3) theta at
        ``target_size`` (``geometry/warp.warp_bilinear``); (B, H, W)."""
        w, h = self.target_size
        t = _template_batch(template, theta.shape[0]).to(theta.device)
        return warp_bilinear(t, theta, (h, w))
